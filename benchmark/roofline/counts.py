"""The least work of each measured layer call, and the card's peaks.

Frozen copies of the repository's roofline counts (the work of each piece
counted from the layer's plain formula, at its least), so that a later
change to the program cannot move them. Each function takes what the layer
call was given, and the iterations those inputs needed, and returns the
call's least time in seconds at the published peaks: the larger of its
bytes over the memory bandwidth and its operations over the FP32 issue
rate and the special-function rate. Each input byte is counted read once
and each output byte written once.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): 3.35
TB/s of HBM3, 67 TFLOP/s FP32 outside the tensor cores (an FMA counted as
two), and 16 special-function results per clock per SM against 128 FP32
(CUDA C++ Programming Guide, compute capability 9.0).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
SFU_PER_S = FP32_INSTR_PER_S / 8
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "fp32_instr_per_s": FP32_INSTR_PER_S,
         "sfu_per_s": SFU_PER_S}


def least_ops(fp32, div=0, sqrt=0, log=0, exp=0, pow=0):
    """(FP32 instructions, special-function ops) of a piece at its least: a
    division or square root is a reciprocal (root) estimate and three FP32
    instructions, a log or exp one special-function op and a product, a pow
    a log2, a product and an exp2; add, multiply, min, max and
    compare-select are one FP32 instruction each."""
    return fp32 + 3 * (div + sqrt) + log + exp + pow, div + sqrt + log + exp + 2 * pow


# the depth round's cost (flow arm, prior arm, normalisation and accept)
COST_PIECES = {
    "cands": least_ops(11, div=1),        # per pixel and candidate
    "chain": least_ops(19),               # per candidate and window frame
    "flow_px": least_ops(19, div=4, sqrt=1, exp=1, pow=2),  # per pixel and frame
    "flow": least_ops(28, div=7, sqrt=1, pow=2, log=1),     # per evaluated flow term
    "prior_px": least_ops(17, div=5, exp=1, pow=2),         # per pixel and prior with a target
    "prior_cands": least_ops(9),          # per candidate at such a pixel
    "prior": least_ops(15, div=6, pow=2, log=1),            # per evaluated prior term
}
# the pose sweep: P4P per hypothesis, meanshift per row and weighting at
# D = 6, the robust-Gaussian refit's E-step and committed M-step per row
P4P_PIECE = least_ops(3700, div=126, sqrt=22)


def ms_piece(D):
    return least_ops(3 * D + 1 + D + 1, div=1, exp=1)


RG_ESTEP = least_ops(58)
RG_MSTEP = least_ops(48)


def bound_s(n_bytes, counts, pieces):
    """Least seconds: the larger of the bytes and the two operation rates."""
    fp32 = sum(counts[k] * pieces[k][0] for k in counts)
    sfu = sum(counts[k] * pieces[k][1] for k in counts)
    return max(n_bytes / HBM_BYTES_PER_S, fp32 / FP32_INSTR_PER_S, sfu / SFU_PER_S)


def cost_counts(torch, cands, track_inb, Rs, ts, active_n, fx, fy, cx, cy, prior_samples, y0=0):
    """How many times the cost evaluates each of COST_PIECES on these
    inputs: the flow terms where a candidate's point lies in front of the
    camera and the pixel's track is inside, the prior terms where the
    prior has a target and the point lies in front of the prior camera."""
    K, h, w = cands.shape
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + h, device=cands.device),
                            torch.arange(w, device=cands.device), indexing="ij")
    bx = (xs.float() - cx) / fx
    by = (ys.float() - cy) / fy
    ox, oy, oz = bx * cands, by * cands, cands
    n = dict(cands=K * h * w, chain=K * active_n * h * w, flow_px=active_n * h * w,
             flow=0, prior_px=0, prior_cands=0, prior=0)
    for f in range(active_n):
        R, t = Rs[f], ts[f]
        ox, oy, oz = (R[0, 0] * ox + R[0, 1] * oy + R[0, 2] * oz + t[0],
                      R[1, 0] * ox + R[1, 1] * oy + R[1, 2] * oz + t[1],
                      R[2, 0] * ox + R[2, 1] * oy + R[2, 2] * oz + t[2])
        n["flow"] += int((track_inb[f] & (oz > 0)).sum())
    if prior_samples is not None:
        tgt, wgt, dRs, dts = prior_samples
        for d in range(tgt.shape[0]):
            has = (tgt[d] > 0) & (wgt[d] > 0)
            nz = dRs[d, 2, 0] * (bx * cands) + dRs[d, 2, 1] * (by * cands) + dRs[d, 2, 2] * cands + dts[d, 2]
            n["prior_px"] += int(has.sum())
            n["prior"] += int((has & (nz > 0)).sum())
        n["prior_cands"] = K * n["prior_px"]
    return n


def cost_bound_s(counts, K, h, w, n_frames, n_priors, accept: bool):
    """A cost call's least seconds: candidates, planes and priors read once;
    the accept writes depth and cost, the score K cost maps."""
    px = h * w
    in_bytes = px * (4 * K + n_frames * (5 * 4 + 1) + n_priors * 8)
    out_bytes = px * 16 if accept else px * 4 * K
    return bound_s(in_bytes + out_bytes, counts, COST_PIECES)


def pose_bound_s(B, M, S, T, ms_iters, rg_iters, rg_max_iters):
    """One _solve_and_fuse call: the P4P pool of B x S hypotheses over M
    correspondences, meanshift (T start trials, then its iterations) and,
    when it ran, the robust-Gaussian refit (its E-steps and committed
    M-steps)."""
    rows = min(4 * S, M) * B
    p4p_bytes = B * M + B * S * 4 * 8 + rows * 20 + B * S * 28
    t = bound_s(p4p_bytes, {"h": B * S}, {"h": P4P_PIECE})
    ms_bytes = B * S * (24 + 4) + B * T * 8 + B * 6 * 4 * 2 + B * 13
    t += bound_s(ms_bytes, {"w": S * (B * T + sum(ms_iters))}, {"w": ms_piece(6)})
    if rg_iters is not None:
        committed = [i - 1 if i < rg_max_iters else i for i in rg_iters]
        rg_bytes = B * S * 28 + B * 42 * 4 * 2 + B * 13
        t += bound_s(rg_bytes, {"e": S * sum(rg_iters), "m": S * sum(committed)},
                     {"e": RG_ESTEP, "m": RG_MSTEP})
    return t

