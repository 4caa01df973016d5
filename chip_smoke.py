#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA device must be present (never falls back to the CPU);
   prints the card's name and power limit from nvidia-smi;
2. build: compiles every hand-written kernel source
   (voldor_tpu_torch/csrc/*.cu, one nvcc each, in parallel) into one
   library in voldor_tpu_torch/_build/; prints ptxas's registers and the
   SASS instruction count of every kernel;
3. fb_smooth vs plain: the kernel against fb_smooth_reference on the card
   at (M, 185, 613), M in {5, 3, 2, 1}, on the bench scene's rigidness
   maps: max abs error within 1e-5;
4. cost kernel, score mode vs plain: the normalised costs against the plain
   composition at the main path's shapes (185x613, N=5, K in {1,4,10}, D in
   {0,1,2,3} -- D=3 with the stereo disparity slot --, active_n in {5,3}):
   identical +inf pattern, finite values within rtol = atol = 1e-5;
5. cost kernel, accept mode vs plain: a random (K=10), a global (K=4) and a
   jump (K=4) proposal batch at N=5, D=2: the accepted depth equals the
   plain composition's at >= 99.9% of pixels; the written cost equals the
   plain one (+inf pattern identical, within 1e-5 + 1e-5 relative) where
   the depths agree, and everywhere the plain cost of the kernel's own
   pick, which at a differing pixel is within 1e-5 relative of the plain
   pick's (a near-tie);
6. device-only times (CUDA events around 100 back-to-back launches of the
   bound C call, no wrapper in between) of the fb_smooth kernel and the
   cost kernel in accept and score mode at K = 1, 4, 10, beside their
   plain versions and their bounds: the larger of the bytes over 3.35 TB/s
   and the least operations of the function on this run's data (counted
   from its plain formula, see least_ops) over the peak FP32 and
   special-function rates; and fb_smooth's serial floor, the latency of
   one forward and one backward step (timed on one thread) times h + w;
7. the VO windows: three consecutive 5-flow mono VO windows of the bench
   scene (613x185, seed 7) through voldor_tpu_torch's VO entry point on the
   card, with 0, 1 and 2 depth priors and the SLAM layer's constant-velocity
   warm start; each window must register 5 transitions, every engine
   tensor must lie on the card, the cost kernel must have been launched at
   least 8 times per flow-fed EM iteration and the fb_smooth kernel at
   least once, and the 16-frame trajectory must pass the bench's gate,
   Sim3 ATE < 0.02 * scene extent;
8. no host sync: the same three windows with every call of the kernel
   wrappers (fb_smooth, cost score, cost accept) run under
   torch.cuda.set_sync_debug_mode("error");
9. times: the median warm wall time of each window, fb_smooth's share of a
   window;
10. slam-mono: VOLDOR_SLAM(mode="mono", device="cuda").process_vo over the
   bench's 24-flow scene (25 frames), configured as the bench configures
   it; one checked pass (every window's device covisibility scores equal
   the same functions run on CPU copies of their inputs within 1e-5, every
   engine tensor and live frame map on the card, >= 8 cost-kernel launches
   per EM iteration and fb_smooth launches, Sim3 ATE < 0.02 * extent),
   then 1 timed pass;
11. slam-stereo: the same scene with disparity bf / depth (bf = 175) in
   mode="stereo"; one checked pass under the metric ATE gate (no scale
   alignment, < 0.02 * extent), then 1 timed pass;
12. falign: a falign_pairs batch of four keyframe pairs of the full-SLAM
   scene (bench.py:240-298: 613x185, 60 flows, out and back, textured) at
   the SLAM layer's local-link settings, without and with images, on the
   card and on the CPU: per lane, the iteration counts, the angle between
   the relative rotations and the difference of the translations within
   FALIGN_LIMITS of the batch's kind (geo, photo), the card's rotation no
   more than FALIGN_TRUTH_ROT farther from the true relative rotation than
   the CPU's; every solver
   tensor on the card, scale ratios within 1e-4,
   scores within FALIGN_SCORE_TOL, and the card's covariances
   within FALIGN_COV_RTOL of pair_covariances on the CPU at the card's
   parameters;
13. PGO: drifted circle graphs with loop edges at 60 and 600 poses through
   pgo() (dense), pgo(reduce_threshold_dofs=0) (chain reduction) and
   pgo_solve_jit (matrix-free CG), on the card and on the CPU: poses within
   PGO_POSE_TOL;
14. mapping times: falign_pairs per call and per batched LM iteration at 4
   and 16 pairs with its kernel launches and host syncs (torch.profiler),
   PGO dense and CG per solve at 60 and 600 poses;
15. slam-full-mono: the full-SLAM scene through VOLDOR_SLAM(mode="mono",
   device="cuda") configured as bench.py:_make_slam_e2e without loop
   closure, vo_thread and mapping_thread as two threads; one checked pass
   (threads joined, finite poses, >= 1 accepted falign-local edge, the
   final global PGO, the kernels' launches, Sim3 ATE < 0.02 * extent), one
   timed pass (frames/s, the share of the wall in falign and in PGO, how
   much of the mapping work overlaps the VO windows), and the ATE of a
   VO-only pass beside the mapped one.

The kernels' launch counts sum the main-path phases (7, 10, 11 and 15).
The second-to-last line of stdout is a JSON record of the kernels; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W = 185, 613
WINDOW = 5
N_WINDOWS = 3
FX = FY = 350.0
BASEFOCAL = (FX + FY) * 0.25  # the SLAM layer's virtual basefocal (mono)
# the mono SLAM layer's VO config (voldor_tpu/slam/system.py:183-186, :230-233)
CONFIG = (
    "--silent --meanshift_kernel_var 0.2 --delta 1.5 --max_iters 5 "
    f"--pose_sample_min_depth {BASEFOCAL / 200.0} --pose_sample_max_depth {BASEFOCAL / 1.0}"
)
RTOL = ATOL = 1e-5
SLAM_FLOWS = 24  # the bench's sequence length (bench.py:435)
BF_STEREO = 0.5 * FX  # bench.py:148
COVIS_TOL = 1e-5
FB_EMM, FB_NCP = 0.5, 0.9  # the shipped fb_emm / fb_no_change_prob
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_INSTR_PER_S = 67e12 / 2  # FP32 issue rate: 67 TFLOP/s counts an FMA as 2
# special-function units (reciprocal, rsqrt, log2, exp2): 16 results per
# clock per SM against 128 FP32 (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0)
SFU_PER_S = FP32_INSTR_PER_S / 8
N_LAUNCH = 100  # back-to-back launches per device-only timing


def least_ops(fp32, div=0, sqrt=0, log=0, exp=0, pow=0):
    """(FP32 instructions, special-function ops) of a piece of a formula at
    their least: a division or square root is a reciprocal (root) estimate
    and three FP32 instructions (a product and one Newton correction), a log
    or exp one special-function op and a scaling product, a pow a log2, a
    product and an exp2. Add, multiply, min, max and compare-select are one
    FP32 instruction each."""
    return fp32 + 3 * (div + sqrt) + log + exp + pow, div + sqrt + log + exp + 2 * pow


# The cost function's pieces (voldor_tpu_torch/ops/cost.py's plain version:
# the flow arm, the prior arm, normalize_cost, accept_reference), counted
# from the formula in its operation order:
COST_PIECES = {
    # per pixel and candidate: back-projection (2), normalisation (div and
    # two compare-selects), mask and argmin step (5)
    "cands": least_ops(11, div=1),
    # per candidate and window frame: the point moved on (9 mul, 9 add) and
    # its nz > 0 test
    "chain": least_ops(19),
    # per pixel and window frame: |observed flow| (3, sqrt, div), its Fisk
    # shape and scale (clamp 3, lam 1, c 2, s 2 + exp) and outlier density
    "flow_px": least_ops(19, div=4, sqrt=1, exp=1, pow=2),
    # per evaluated flow term: safe nz (2), projection (6 + 2 div), residual
    # (4), its norm (3, sqrt, div), Fisk density (8, 3 div, 2 pow), ratio (1,
    # div), -rig * log(max(r, 1e-30)) summed (3, log), weight sum (1)
    "flow": least_ops(28, div=7, sqrt=1, pow=2, log=1),
    # per pixel and prior with a target: its disparity (1, 2 div) and Fisk
    # model (lam 1, clamp 3, c 2, s 2 + exp, outlier density 8, 3 div, 2 pow)
    "prior_px": least_ops(17, div=5, exp=1, pow=2),
    # per candidate at such a pixel: the frame-0 point's depth in the prior
    # camera (8) and its nz > 0 test
    "prior_cands": least_ops(9),
    # per evaluated prior term: disparity (1, 2 div), |difference| (1), Fisk
    # density (8, 3 div, 2 pow), ratio (1, div), log sum (3, log), weight (1)
    "prior": least_ops(15, div=6, pow=2, log=1),
}
# fb_smooth per element and direction: forward step (11, div), backward step
# (13, div), posterior (7, div)
FB_PIECE = least_ops(31, div=3)


def log(*a):
    print(*a, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def build_scene(np, torch, n_flows):
    """The bench's sequence scene (bench.py:82-113), rendered with the port's
    so3_exp."""
    from synthetic import render_window

    from voldor_tpu_torch.ops.lie import so3_exp

    K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)

    def n_(v):
        v = np.asarray(v, np.float64)
        return v / np.linalg.norm(v)

    planes = [
        (n_([0.1, 0.15, 1.0]), 8.0),
        (n_([-0.35, 0.1, 1.0]), 6.5),
        (n_([0.3, -0.25, 1.0]), 7.0),
        (n_([0.5, 0.35, 1.0]), 7.5),
    ]
    rng = np.random.default_rng(7)
    poses = np.zeros((n_flows, 6), np.float32)
    for f in range(n_flows):
        poses[f, :3] = rng.normal(0, 0.004, 3)
        poses[f, 3:6] = [0.08, 0.01, 0.3]

    def r2R(rv):
        return so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy()

    flows, depth0, Ts = render_window(K, poses, planes, H, W, r2R)
    return K, planes, poses, flows, depth0, Ts, r2R


def phase_build():
    """The package's kernels: one nvcc per source, in parallel."""
    from voldor_tpu_torch.ops import _build

    _build.build()
    log(f"[build] {len(_build.sources())} sources -> {_build.library_path().name}: nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}; {_build.build_seconds or 0.0:.2f} s build")
    report = _build.ptxas_report()
    for fn, spill, regs in re.findall(
            r"Function properties for (\S+)\n.*?(\d+) bytes spill stores.*?Used (\d+) registers",
            report, re.S):
        log(f"[build] ptxas {short_name(fn)}: {regs} registers, {spill} bytes spilled")


def short_name(mangled):
    m = re.search(r"cost_kernelILi(\d+)ELb([01])E", mangled)
    if m:
        return f"cost_kernel<KT={m.group(1)}, {'accept' if m.group(2) == '1' else 'score'}>"
    m = re.search(r"(fb_rows_kernel|fb_cols_kernel|fb_chain_probe_kernel)", mangled)
    return m.group(1) if m else mangled


def sass_counts():
    """Static SASS instruction count of every kernel in the library."""
    from voldor_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          check=True, capture_output=True, text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    counts = {short_name(name): len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[A-Z@]", body))
              for name, body in zip(parts[1::2], parts[2::2])}
    for name, n in counts.items():
        log(f"[build] SASS {name}: {n} instructions")
    return counts


def bench_inputs(np, torch, scene):
    """The main path's operands at full size on the bench scene: the
    window's rigidness and tracks, three priors with their poses."""
    from synthetic import plane_depth

    from voldor_tpu_torch.config import VoldorConfig
    from voldor_tpu_torch.ops.lie import T44_to_pose6, so3_exp
    from voldor_tpu_torch.vo import em

    K, planes, poses, flows, depth0, Ts, _ = scene
    dev = torch.device("cuda")
    cfg = VoldorConfig(fx=FX, fy=FY, cx=W / 2, cy=H / 2, basefocal=BASEFOCAL)
    cfg.read_config(CONFIG)
    p = em.EmParams.from_config(cfg, False)
    fl = torch.as_tensor(flows[:WINDOW], device=dev)
    Rs = so3_exp(torch.as_tensor(poses[:WINDOW, :3], device=dev))
    ts = torch.as_tensor(poses[:WINDOW, 3:6], device=dev)
    d0 = torch.as_tensor(depth0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    u = torch.rand((10, H, W), generator=gen, device=dev)
    jitter = 1.0 + 0.3 * (torch.rand((10, H, W), generator=gen, device=dev) - 0.5)
    cands_all = torch.cat([d0[None], d0[None] * jitter[:5], 1.0 / (u[:4] + 1e-5)]).contiguous()
    # priors: the frame-0 depth (identity pose: the stereo disparity slot
    # when D = 3), the frame-1 depth (pose 0 maps frame-0 points into
    # frame 1) and the frame-2 depth
    depth1 = plane_depth(K, Ts[1][:3, :3], Ts[1][:3, 3], planes, H, W)
    depth2 = plane_depth(K, Ts[2][:3, :3], Ts[2][:3, 3], planes, H, W)
    priors = torch.as_tensor(np.stack([depth0 * 1.01, depth1, depth2]), device=dev)
    dp_poses = np.stack([np.zeros(6, np.float32), poses[0],
                         T44_to_pose6(torch.as_tensor(Ts[2], dtype=torch.float32)).numpy()])
    return dict(
        p=p, fl=fl, Rs=Rs, ts=ts, d0=d0, gen=gen, cands_all=cands_all, priors=priors,
        dp_Rs=so3_exp(torch.as_tensor(dp_poses[:, :3], device=dev)),
        dp_ts=torch.as_tensor(dp_poses[:, 3:6], device=dev),
        pconfs=torch.full((3, H, W), 0.9, device=dev),
        confs=torch.rand((3, H, W), generator=gen, device=dev),
    )


def planes_at(bi, active_n, D, stereo=False):
    """(rig, track, tinb), prior samples of D priors, at active_n frames."""
    from voldor_tpu_torch.vo import em

    p = bi["p"]
    rig = em.update_rigidness(bi["d0"], bi["fl"], bi["Rs"], bi["ts"], active_n, p).contiguous()
    track, tinb = em.precompute_obs_tracks(bi["fl"], active_n, p)
    ps = None
    if D:
        ps = em.precompute_prior_samples(
            bi["d0"], bi["priors"][:D], bi["pconfs"][:D], bi["confs"][:D], bi["dp_Rs"][:D],
            bi["dp_ts"][:D], p._replace(disp_delta=1.0) if stereo else p,
        )
    return rig, track, tinb, ps


def phase_fb(np, torch, bi):
    """fb_smooth kernel against its plain version on the bench's rigidness."""
    from voldor_tpu_torch.ops import fb_smooth as fb

    rig, _, _, _ = planes_at(bi, WINDOW, 0)
    max_err = 0.0
    for m in (5, 3, 2, 1):
        x = rig[:m].contiguous()
        got = fb.fb_smooth(x, FB_EMM, FB_NCP)
        ref = fb.fb_smooth_reference(x, FB_EMM, FB_NCP)
        torch.cuda.synchronize()
        err = float(torch.abs(got - ref).max())
        max_err = max(max_err, err)
        log(f"[fb_smooth] M={m} {H}x{W}: max_abs_err {err:.3e}, bitwise equal "
            f"{bool(torch.equal(got, ref))}")
        if not err <= ATOL:
            raise AssertionError(f"fb_smooth kernel disagrees with its plain version (M={m})")
    return max_err


def phase_score(np, torch, bi):
    """Cost kernel in score mode against the plain composition."""
    from voldor_tpu_torch.ops import cost as cost_mod

    p, Rs, ts, cands_all = bi["p"], bi["Rs"], bi["ts"], bi["cands_all"]
    max_err = 0.0
    for active_n in (5, 3):
        for D in (0, 1, 2, 3):
            rig, track, tinb, ps = planes_at(bi, active_n, D, stereo=D == 3)
            for k in (1, 4, 10):
                cands = cands_all[:k].contiguous()
                args = (cands, track, tinb, rig, Rs, ts, active_n, p)
                got = cost_mod.cost_map_score(*args, prior_samples=ps)
                ref = cost_mod.normalize_cost(*cost_mod.cost_map_tracked_reference(*args, prior_samples=ps))
                torch.cuda.synchronize()
                fin = torch.isfinite(ref)
                if not torch.equal(fin, torch.isfinite(got)):
                    raise AssertionError(f"+inf pattern differs (K={k}, D={D}, active_n={active_n})")
                g, r = got[fin], ref[fin]
                bad = (torch.abs(g - r) > ATOL + RTOL * torch.abs(r)).sum().item()
                err = float(torch.abs(g - r).max()) if g.numel() else 0.0
                max_err = max(max_err, err)
                log(f"[score] K={k} D={D} active_n={active_n}: finite {int(fin.sum())}/{fin.numel()} "
                    f"max_abs_err {err:.3e} out-of-tol {bad}")
                if bad:
                    raise AssertionError(f"kernel disagrees with its plain version (K={k}, D={D}, active_n={active_n})")
    return max_err


def accept_batches(torch, bi, depth):
    """The three proposal families of a depth round at full size:
    (name, cands, masks) for random (K=10), global (K=4), jump (K=4, o=1)."""
    from voldor_tpu_torch.vo import em

    u = torch.rand((10, H, W), generator=bi["gen"], device=depth.device)
    rand = (1.0 / (u + 1.0 / em.MAXIMUM_DEPTH)).contiguous()
    gc, gm = [], []
    for dy, dx, along_x, start_hi in em._GLOBAL_DIRS:
        cand, valid = em._shift_depth(depth, dy, dx)
        gc.append(cand)
        gm.append(valid & em._global_mask(H, W, along_x, start_hi, 8, depth.device))
    jc, jm = [], []
    for sy, sx in em._LOCAL_DIRS:
        cand, valid = em._shift_depth(depth, sy, sx)
        jc.append(cand)
        jm.append(valid)
    return [("random", rand, None), ("global", torch.stack(gc), torch.stack(gm)),
            ("jump", torch.stack(jc), torch.stack(jm))]


def phase_accept(np, torch, bi):
    """Cost kernel in accept mode against the plain composition, N=5, D=2."""
    from voldor_tpu_torch.ops import cost as cost_mod

    p, Rs, ts = bi["p"], bi["Rs"], bi["ts"]
    rig, track, tinb, ps = planes_at(bi, WINDOW, 2)
    planes = (track, tinb, rig, Rs, ts, WINDOW, p)
    jit = 1.0 + 0.1 * (torch.rand((H, W), generator=bi["gen"], device="cuda") - 0.5)
    depth = (bi["d0"] * jit).contiguous()
    cost = cost_mod.normalize_cost(*cost_mod.cost_map_tracked_reference(
        depth[None], *planes, prior_samples=ps))[0]
    worst = 1.0
    for name, cands, masks in accept_batches(torch, bi, depth):
        costs = cost_mod.normalize_cost(*cost_mod.cost_map_tracked_reference(
            cands, *planes, prior_samples=ps))
        d_ref, c_ref = cost_mod.accept_reference(depth, cost, costs, cands, masks)
        d_k, c_k = cost_mod.cost_map_accept(depth.clone(), cost.clone(), cands, masks, *planes,
                                            prior_samples=ps)
        torch.cuda.synchronize()
        same = d_k == d_ref
        frac = float(same.float().mean())
        worst = min(worst, frac)
        # the plain cost of the kernel's pick: the candidate it took, or the
        # pixel's own cost where it kept the pixel
        kept = masks if masks is not None else torch.ones_like(cands, dtype=torch.bool)
        hit = (cands == d_k[None]) & kept
        k_pick = torch.argmax(hit.to(torch.uint8), dim=0)
        took = hit.any(dim=0) & ((d_k != depth) | (c_k != cost))
        pick_cost = torch.where(took, torch.gather(costs, 0, k_pick[None])[0], cost)
        diff = ~same
        a, b = pick_cost[diff], c_ref[diff]
        near = torch.abs(a - b) <= 1e-5 * torch.maximum(torch.abs(a), torch.abs(b)) + 1e-7
        rel = float((torch.abs(a - b) / torch.clamp_min(torch.abs(b), 1e-30)).max()) if a.numel() else 0.0
        # the written cost: the plain one where the depths agree, the plain
        # cost of the kernel's own pick everywhere
        inf_same = torch.equal(torch.isinf(c_k[same]), torch.isinf(c_ref[same]))
        cost_same = int((~close(c_k[same], c_ref[same])).sum())
        cost_pick = int((~close(c_k, pick_cost)).sum())
        fin = torch.isfinite(c_k) & torch.isfinite(c_ref) & same
        err = float(torch.abs(c_k[fin] - c_ref[fin]).max()) if bool(fin.any()) else 0.0
        log(f"[accept] {name} K={cands.shape[0]}: same depth at {frac:.6f} of pixels "
            f"({int(diff.sum())} differ, accepted {int((d_ref != depth).sum())} plain / "
            f"{int((d_k != depth).sum())} kernel), largest relative cost gap at a "
            f"difference {rel:.3e}; written cost vs plain where the depths agree: +inf "
            f"pattern identical {inf_same}, max abs err {err:.3e}, out-of-tol {cost_same}; "
            f"vs the plain cost of the kernel's pick: out-of-tol {cost_pick}")
        if frac < 0.999 or not bool(near.all()):
            raise AssertionError(f"accept mode disagrees with the plain composition ({name})")
        if not inf_same or cost_same or cost_pick:
            raise AssertionError(f"accept mode writes a cost that disagrees with the plain one ({name})")
    return worst


def close(a, b):
    """Equal (+inf to +inf), within ATOL + RTOL * |b| of a finite b, or both NaN."""
    near = ((a - b).abs() <= ATOL + RTOL * b.abs()) & b.isfinite()
    return (a == b) | near | (a.isnan() & b.isnan())


def count_pieces(torch, cands, tinb, Rs, ts, active_n, p, ps):
    """How many times the cost function evaluates each of COST_PIECES on
    these inputs (the Fisk terms where a point lies in front of the camera,
    the prior terms where the prior has a target)."""
    from voldor_tpu_torch.ops import fisk

    K = cands.shape[0]
    ys, xs = torch.meshgrid(torch.arange(H, device=cands.device),
                            torch.arange(W, device=cands.device), indexing="ij")
    bx = fisk.div_scalar(xs.float() - p.cx, p.fx)
    by = fisk.div_scalar(ys.float() - p.cy, p.fy)
    ox, oy, oz = bx * cands, by * cands, cands
    n = dict(cands=K * H * W, chain=K * active_n * H * W, flow_px=active_n * H * W,
             flow=0, prior_px=0, prior_cands=0, prior=0)
    for f in range(active_n):
        R, t = Rs[f], ts[f]
        ox, oy, oz = (R[0, 0] * ox + R[0, 1] * oy + R[0, 2] * oz + t[0],
                      R[1, 0] * ox + R[1, 1] * oy + R[1, 2] * oz + t[1],
                      R[2, 0] * ox + R[2, 1] * oy + R[2, 2] * oz + t[2])
        n["flow"] += int((tinb[f] & (oz > 0)).sum())
    if ps is not None:
        tgt, wgt, dRs, dts = ps
        for d in range(tgt.shape[0]):
            has = (tgt[d] > 0) & (wgt[d] > 0)
            nz = dRs[d, 2, 0] * (bx * cands) + dRs[d, 2, 1] * (by * cands) + dRs[d, 2, 2] * cands + dts[d, 2]
            n["prior_px"] += int(has.sum())
            n["prior"] += int((has & (nz > 0)).sum())
        n["prior_cands"] = K * n["prior_px"]
    return n


def ops_ms(counts, pieces):
    """(FP32 ms, special-function ms) of the counted pieces at peak rate."""
    fp32 = sum(counts[k] * pieces[k][0] for k in counts)
    sfu = sum(counts[k] * pieces[k][1] for k in counts)
    return fp32 / FP32_INSTR_PER_S * 1e3, sfu / SFU_PER_S * 1e3


def device_ms(torch, launch, n=N_LAUNCH):
    """Mean device time of one launch over n back-to-back launches."""
    for _ in range(3):
        launch()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def event_ms(torch, fn, reps):
    """Median time of fn over reps calls, CUDA events around each."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def checked(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def chain_floor_ms(torch):
    """fb_smooth's serial floor at h x w: one forward and one backward step
    timed on one thread (5e5 of each), times h + w (each row walks w of
    both, each column h). Returns (floor ms, ns per step pair)."""
    from voldor_tpu_torch.ops import _build
    from voldor_tpu_torch.ops import fb_smooth as fb

    fn = _build.function("fb_chain_probe_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int]
                         + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    e = torch.tensor([0.7, 0.6], device="cuda")
    out = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    consts = fb._constants(FB_EMM, FB_NCP)
    n = 500_000
    checked(fn(e.data_ptr(), out.data_ptr(), 1000, *consts, stream), "chain probe")
    ms = event_ms(torch, lambda: checked(fn(e.data_ptr(), out.data_ptr(), n, *consts, stream),
                                          "chain probe"), 3)
    if not 0.0 < float(out) < 1.0:
        raise AssertionError(f"chain probe left {float(out)}, not a probability")
    return ms / n * (H + W), ms / n * 1e6


def phase_times(np, torch, bi, sass):
    """Device-only times of both kernels, their plain versions' times and
    their bounds. Returns the kernels' records."""
    from voldor_tpu_torch.ops import _build
    from voldor_tpu_torch.ops import cost as cost_mod
    from voldor_tpu_torch.ops import fb_smooth as fb

    stream = torch.cuda.current_stream().cuda_stream
    p, Rs, ts = bi["p"], bi["Rs"], bi["ts"]
    rig, track, tinb, ps = planes_at(bi, WINDOW, 2)
    planes = (track, tinb, rig, Rs, ts, WINDOW, p)
    px = H * W

    # fb_smooth at M = 5 (the rigidness stack) and M = 2 (dp_confs)
    fb_fn = _build.function("fb_smooth_launch", fb._ARGTYPES)
    fb_rec = {}
    for m in (5, 2):
        x = rig[:m].contiguous()
        mid, out = torch.empty_like(x), torch.empty_like(x)
        args = (x.data_ptr(), mid.data_ptr(), out.data_ptr(), m, H, W,
                *fb._constants(FB_EMM, FB_NCP), stream)
        fb_rec[m] = device_ms(torch, lambda: checked(fb_fn(*args), "fb_smooth"))
    x5 = rig.contiguous()
    plain1 = event_ms(torch, lambda: fb.fb_smooth_reference(x5, FB_EMM, FB_NCP), 3)
    kern = device_ms(torch, lambda: fb.fb_smooth(x5, FB_EMM, FB_NCP))
    plain2 = event_ms(torch, lambda: fb.fb_smooth_reference(x5, FB_EMM, FB_NCP), 3)
    fb_bytes = 2 * 4 * WINDOW * px
    fb_fp32, fb_sfu = ops_ms({"el": 2 * WINDOW * px}, {"el": FB_PIECE})
    fb_by_bytes = fb_bytes / HBM_BYTES_PER_S * 1e3
    fb_bound = max(fb_by_bytes, fb_fp32, fb_sfu)
    chain_ms, pair_ns = chain_floor_ms(torch)
    log(f"[times] fb_smooth M=5 {H}x{W}: device {fb_rec[5]:.4f} ms per call ({N_LAUNCH} "
        f"launches; M=2 {fb_rec[2]:.4f} ms; through the wrapper {kern:.4f} ms), plain "
        f"{plain1:.4f} / {plain2:.4f} ms (order plain, kernel, plain); bound "
        f"{fb_bound * 1e3:.3f} us (bytes {fb_by_bytes * 1e3:.3f} us for {fb_bytes} B, FP32 "
        f"{fb_fp32 * 1e3:.3f} us, special-function {fb_sfu * 1e3:.3f} us); serial floor "
        f"{chain_ms * 1e3:.3f} us ({H + W} forward + backward step pairs at {pair_ns:.3f} ns "
        f"each, timed on one thread)")

    # the cost kernel in accept and score mode
    slope = (sass["cost_kernel<KT=10, accept>"] - sass["cost_kernel<KT=4, accept>"]) / 6
    D = ps[0].shape[0]
    cost_rec = {}
    for k in (1, 4, 10):
        cands = bi["cands_all"][:k].contiguous()
        depth = bi["d0"].clone()
        cost = cost_mod.cost_map_score(depth[None], *planes, prior_samples=ps)[0].clone()
        out = torch.empty_like(cands)
        acc_fn, acc_args, _k1 = cost_mod._bind(cost_mod._ACCEPT, cands, *planes, ps,
                                              depth=depth, cost=cost)
        sc_fn, sc_args, _k2 = cost_mod._bind(cost_mod._SCORE, cands, *planes, ps, out=out)
        runs = {"score": [], "accept": []}
        for order in (("score", "accept"), ("accept", "score")):
            for name in order:
                fn, args = (sc_fn, sc_args) if name == "score" else (acc_fn, acc_args)
                runs[name].append(device_ms(torch, lambda: checked(fn(*args), name)))
        n = count_pieces(torch, cands, tinb, Rs, ts, WINDOW, p, ps)
        fp32_ms, sfu_ms = ops_ms(n, COST_PIECES)
        in_bytes = px * (4 * k + WINDOW * (5 * 4 + 1) + D * 8)
        by_bytes = {"accept": (in_bytes + px * 16) / HBM_BYTES_PER_S * 1e3,
                    "score": (in_bytes + px * 4 * k) / HBM_BYTES_PER_S * 1e3}
        bounds = {m: max(b, fp32_ms, sfu_ms) for m, b in by_bytes.items()}
        sass_ms = (n["flow"] + n["prior"]) * slope / 2 / FP32_INSTR_PER_S * 1e3
        cost_rec[k] = {m: min(v) for m, v in runs.items()}
        log(f"[times] cost K={k} N={WINDOW} D={D}: device ms per launch (min of two rounds of "
            f"{N_LAUNCH}) accept {runs['accept']}, score {runs['score']}; evaluated {n}; least "
            f"operations FP32 {fp32_ms * 1e3:.2f} us, special-function {sfu_ms * 1e3:.2f} us; "
            f"bytes accept {by_bytes['accept'] * 1e3:.2f} us, score {by_bytes['score'] * 1e3:.2f} "
            f"us; bound (largest) accept {bounds['accept'] * 1e3:.2f} us, score "
            f"{bounds['score'] * 1e3:.2f} us. Static-SASS estimate of this implementation's "
            f"work (not a bound): ~{slope / 2:.0f} instructions per term, "
            f"{sass_ms * 1e3:.2f} us at the FP32 issue rate")
        cost_rec[k]["bound"] = bounds
        cost_rec[k]["bound_by"] = "operations" if max(fp32_ms, sfu_ms) > by_bytes["accept"] else "bytes"

    # the plain composition the kernel's accept replaces, at K = 10
    cands = bi["cands_all"]
    depth = bi["d0"].clone()
    cost = cost_mod.cost_map_score(depth[None], *planes, prior_samples=ps)[0].clone()

    def plain_accept():
        costs = cost_mod.normalize_cost(*cost_mod.cost_map_tracked_reference(cands, *planes, prior_samples=ps))
        return cost_mod.accept_reference(depth, cost, costs, cands, None)

    pa1 = event_ms(torch, plain_accept, 10)
    wrap = device_ms(torch, lambda: cost_mod.cost_map_accept(depth, cost, cands, None, *planes, prior_samples=ps))
    pa2 = event_ms(torch, plain_accept, 10)
    log(f"[times] cost accept K=10: plain composition {pa1:.4f} / {pa2:.4f} ms, kernel through "
        f"the wrapper {wrap:.4f} ms per call ({N_LAUNCH} calls; order plain, kernel, plain)")
    fb_record = dict(ms=fb_rec[5], plain_ms=min(plain1, plain2), bound_ms=fb_bound,
                     bound_by="bytes" if fb_by_bytes >= max(fb_fp32, fb_sfu) else "operations",
                     ms_m2=fb_rec[2], chain_floor_ms=chain_ms, chain_step_pair_ns=pair_ns)
    c10 = cost_rec[10]
    cost_record = dict(ms=c10["accept"], plain_ms=min(pa1, pa2), bound_ms=c10["bound"]["accept"],
                       bound_by=c10["bound_by"], score_ms=c10["score"],
                       ms_by_k={k: {m: r[m] for m in ("accept", "score")} for k, r in cost_rec.items()})
    return fb_record, cost_record


def run_sequence(np, torch, scene, check=False):
    """Three consecutive windows with 0, 1 and 2 depth priors, driven the way
    the SLAM layer drives them (voldor_tpu/slam/system.py:535-575).

    Returns (cam->world poses of the 16 frames, per-window wall seconds,
    per-window EM iterations, bootstrap route)."""
    import voldor_tpu_torch
    from voldor_tpu_torch.ops.lie import T44_to_pose6, pose6_to_T44

    _, _, _, flows, _, _, _ = scene

    def T6(T):
        return T44_to_pose6(torch.as_tensor(np.asarray(T, np.float32))).numpy()

    Twc = np.eye(4, dtype=np.float32)  # world -> current camera
    frames_Tcw = []  # cam -> world per frame
    kf = []  # (fid, depth, conf) of earlier window starts, newest first
    walls, iters, route = [], [], None
    for wi in range(N_WINDOWS):
        fid = wi * WINDOW
        kw = {}
        if kf:
            use = kf[:2]
            kw["depth_priors"] = [d for _, d, _ in use]
            kw["depth_prior_pconfs"] = [c for _, _, c in use]
            kw["depth_prior_poses"] = np.stack(
                [T6(np.linalg.inv(Twc @ frames_Tcw[f])) for f, _, _ in use]
            )
            rel = Twc @ frames_Tcw[fid - 1]
            kw["poses_init"] = np.tile(T6(rel), (WINDOW, 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win = voldor_tpu_torch.voldor_dispatch(
            flows[fid:fid + WINDOW], FX, FY, W / 2, H / 2, basefocal=BASEFOCAL,
            config=CONFIG, pad_window_to=WINDOW, device="cuda", **kw,
        )
        res = win.collect()
        depth, conf = win.depth_host(), win.conf_host()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        eng = win.engine
        iters.append(eng.iters_cur)
        if wi == 0:
            route = eng.bootstrap_route
        if check:
            if res["n_registered"] != WINDOW:
                raise AssertionError(f"window {wi} registered {res['n_registered']} of {WINDOW}")
            for name, val in vars(eng).items():
                if isinstance(val, torch.Tensor) and val.device.type != "cuda":
                    raise AssertionError(f"engine tensor {name} is on {val.device}")
            if not (np.isfinite(depth).all() and np.isfinite(res["poses"]).all()):
                raise AssertionError(f"window {wi}: non-finite output")
        Tc = pose6_to_T44(torch.as_tensor(res["poses"])).numpy()
        for i in range(WINDOW):
            frames_Tcw.append(np.linalg.inv(Twc))
            Twc = (Tc[i] @ Twc).astype(np.float32)
        kf.insert(0, (fid, depth, conf))
    frames_Tcw.append(np.linalg.inv(Twc))
    return np.stack(frames_Tcw), walls, iters, route


def make_slam(mode, flows, disps=None):
    """VOLDOR_SLAM on the card, configured as bench.py:411-425 (mono) and
    bench.py:171-182 (stereo) configure it."""
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    slam = VOLDOR_SLAM(mode=mode, device="cuda")
    slam.use_image_info = False
    slam.voldor_user_config = ""
    if mode == "stereo":
        slam.set_cam_params(FX, FY, W / 2, H / 2, basefocal=BF_STEREO)
        slam.disps = list(disps)
        slam.disp_loader_pt = len(disps)
    else:
        slam.set_cam_params(FX, FY, W / 2, H / 2)
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = flows.shape[0]
    return slam


def check_window_covis(np, torch, handle, inputs):
    """A window's device covis / spakf_covis scores against the same
    functions (ops/covis.py) run on CPU copies of their inputs."""
    from voldor_tpu_torch.ops.covis import covis_keyframe, covis_window
    from voldor_tpu_torch.vo.engine import _to_tensor

    res = handle.collect()
    eng, cfg, cpu = handle.engine, handle.cfg, torch.device("cpu")
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]], dtype=torch.float32)
    thresh = float(np.float32(inputs["covis_spec"]["conf_thresh"]))
    n_flows = eng._st_scalars[0]
    pairs = [("covis", covis_window(eng.depth.cpu(), handle.conf_dev.cpu(), eng.poses6.cpu(),
                                    n_flows, K, thresh, n_cap=handle.n_true))]
    spa = inputs["covis_spec"].get("spakf")
    if spa is not None:
        sdep, sconf, sscale, M = spa
        pairs.append(("spakf_covis", covis_keyframe(
            _to_tensor(sdep, cpu), _to_tensor(sconf, cpu), float(np.float32(sscale)),
            eng.poses6.cpu(), n_flows, _to_tensor(M, cpu), K, thresh, n_cap=handle.n_true)))
    err = 0.0
    for name, ref in pairs:
        e = float(np.abs(res[name] - ref.numpy()).max())
        err = max(err, e)
        if not e <= COVIS_TOL:
            raise AssertionError(f"window at fid {inputs['fid']}: device {name} {res[name]} vs "
                                 f"the CPU run {ref.numpy()}")
    return err


def reset_counts():
    from voldor_tpu_torch.ops import cost as cost_mod
    from voldor_tpu_torch.ops import fb_smooth as fb

    cost_mod.cost_kernel_launches = cost_mod.cost_score_launches = 0
    fb.fb_smooth_kernel_launches = 0


def read_counts():
    from voldor_tpu_torch.ops import cost as cost_mod
    from voldor_tpu_torch.ops import fb_smooth as fb

    return dict(cost=cost_mod.cost_kernel_launches, score=cost_mod.cost_score_launches,
                fb=fb.fb_smooth_kernel_launches)


def check_counts(what, counts, em_iters):
    if counts["cost"] < 8 * em_iters:
        raise AssertionError(f"{what}: cost kernel launched {counts['cost']} times, "
                             f"expected >= {8 * em_iters}")
    if counts["fb"] < 1:
        raise AssertionError(f"{what}: the fb_smooth kernel was never launched")


def run_slam_pass(np, torch, mode, flows, disps=None, check=False):
    """One pass of process_vo to the end of the sequence. Returns the SLAM
    object, the pass's wall seconds and its per-pass counts."""
    slam = make_slam(mode, flows, disps)
    dispatched = []
    dispatch_s = [0.0]
    dispatch = slam._vo_dispatch

    def counting_dispatch(inputs):
        t = time.perf_counter()
        handle = dispatch(inputs)
        dispatch_s[0] += time.perf_counter() - t
        dispatched.append((handle, inputs))
        return handle

    slam._vo_dispatch = counting_dispatch
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        fid = slam.fid_cur
        if not slam.process_vo():
            break
        steps.append(slam.fid_cur - fid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    consumed = [(h, i) for h, i in dispatched if h._res is not None]
    stats = dict(
        windows=len(dispatched), flushes=len(dispatched) - len(consumed),
        keyframes=len(slam.kf_ids), vo_steps=steps,
        em_iters=sum(int(h.engine._st_scalars[1]) for h, _ in dispatched),
        priors=[h.engine.n_depth_priors for h, _ in dispatched],  # D per window
        dispatch_s=dispatch_s[0],
    )
    if check:
        if len(slam.frames) != flows.shape[0] + 1:
            raise AssertionError(f"{mode}: {len(slam.frames)} frames, expected {flows.shape[0] + 1}")
        for h, _ in dispatched:
            for name, val in vars(h.engine).items():
                if isinstance(val, torch.Tensor) and val.device.type != "cuda":
                    raise AssertionError(f"{mode}: engine tensor {name} is on {val.device}")
        for fid, f in enumerate(slam.frames):
            for t in (f.depth_dev, f.conf_dev):
                if t is not None and t.device.type != "cuda":
                    raise AssertionError(f"{mode}: frame {fid} map is on {t.device}")
            if not np.isfinite(f.Tcw).all():
                raise AssertionError(f"{mode}: frame {fid} pose is not finite")
        stats["covis_max_err"] = max(check_window_covis(np, torch, h, i) for h, i in consumed)
    return slam, dt, stats


def phase_slam(np, torch, mode, flows, gt, disps=None, n_timed=3):
    """slam-mono / slam-stereo: one checked pass with the launches counted,
    then n_timed timed passes. Returns (launch counts, median frames/s, ATE)."""
    from voldor_tpu_torch.utils.evaluation import ate_rmse

    with_scale = mode == "mono"  # stereo is metric: no scale alignment
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    reset_counts()
    slam, dt0, st = run_slam_pass(np, torch, mode, flows, disps, check=True)
    counts = read_counts()
    ate = ate_rmse(np.stack([f.Tcw for f in slam.frames]).astype(np.float64), gt, with_scale=with_scale)
    log(f"[slam-{mode}] checked pass: {len(slam.frames)} frames in {dt0:.4f} s; windows dispatched "
        f"{st['windows']}, pipeline flushes {st['flushes']}, keyframes {st['keyframes']} {slam.kf_ids}, "
        f"vo_steps {st['vo_steps']}, depth priors per window {st['priors']}; "
        f"EM iterations {st['em_iters']}, cost kernel launches {counts['cost']} "
        f"({counts['score']} in score mode), fb_smooth kernel launches {counts['fb']}; "
        f"device covis vs the same functions on the CPU max abs err {st['covis_max_err']:.3e} "
        f"(tol {COVIS_TOL:g})")
    log(f"[slam-{mode}] {'Sim3' if with_scale else 'metric'} ATE {ate:.6f} vs gate "
        f"{0.02 * extent:.6f} (extent {extent:.4f})")
    check_counts(mode, counts, st["em_iters"])
    if not ate < 0.02 * extent:
        raise AssertionError(f"{mode}: trajectory fails the ATE gate")
    n_frames = flows.shape[0] + 1
    dts = []
    for _ in range(n_timed):
        slam, dt, st = run_slam_pass(np, torch, mode, flows, disps)
        ate_t = ate_rmse(np.stack([f.Tcw for f in slam.frames]).astype(np.float64), gt,
                         with_scale=with_scale)
        log(f"[slam-{mode}] timed pass: {n_frames / dt:.4f} frames/s, pipeline {dt:.4f} s "
            f"({st['dispatch_s']:.4f} s inside voldor_dispatch); windows "
            f"{st['windows']}, flushes {st['flushes']}, keyframes {st['keyframes']}, "
            f"vo_steps {st['vo_steps']}, EM iterations {st['em_iters']}, ATE {ate_t:.6f}")
        if not ate_t < 0.02 * extent:
            raise AssertionError(f"{mode}: timed pass fails the ATE gate")
        dts.append(dt)
    med = statistics.median(dts)
    log(f"[slam-{mode}] median of {n_timed}: {n_frames / med:.4f} frames/s ({med:.4f} s per pass)")
    return counts, n_frames / med, ate


def phase_no_sync(np, torch, scene):
    """The three windows again, every kernel-wrapper call of their depth
    rounds under torch.cuda.set_sync_debug_mode("error")."""
    from voldor_tpu_torch.vo import engine as engine_mod

    calls = {}

    def guarded(name, fn):
        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return wrapper

    names = ("fb_smooth", "cost_map_score", "cost_map_accept")
    orig = {n: getattr(engine_mod, n) for n in names}
    for n in names:
        setattr(engine_mod, n, guarded(n, orig[n]))
    try:
        run_sequence(np, torch, scene)
    finally:
        for n in names:
            setattr(engine_mod, n, orig[n])
    log(f"[no-sync] wrapper calls under set_sync_debug_mode('error') over the 3 windows: {calls}")
    if set(calls) != set(names):
        raise AssertionError(f"not every kernel wrapper ran: {calls}")



# --------------------------------------------------------------------------
# the mapping half: falign, PGO, the full SLAM pass
# --------------------------------------------------------------------------

SLAM_E2E_FLOWS = 60  # bench.py:357
# falign, card vs the CPU run, per lane and per kind of batch: LM
# iterations (coarse and fine, each), the angle between the two relative
# rotations (rad) and the largest difference of their translations (the
# true translation is 1.1 long). Set at about twice the largest of the
# card's readings against the CPU over six seeded batches
# (tools/falign_card_vs_cpu.py; geo 30 iterations, 5.9e-4 rad, 5.2e-3;
# photo 37, 1.2e-3 rad, 7.6e-3). The iterations are a loose check: a lane
# whose cost has flattened ends on a run of float-noise accepts and
# rejects, and the CPU alone, its init moved by 1e-6, moves them by up to
# 27. The true relative rotations are 5.5e-3 to 1.2e-2 rad, so the
# rotation limits reject a wrong rotation.
FALIGN_LIMITS = {
    "geo": dict(iters=40, rot=1.2e-3, trans=1e-2),
    "photo": dict(iters=45, rot=2.5e-3, trans=1.5e-2),
}
# how much farther from the true relative rotation the card's solve may
# land than the CPU's (rad; read at most 1.7e-4 over the same batches)
FALIGN_TRUTH_ROT = 5e-4
FALIGN_SCORE_TOL = 1e-3  # visibility / consistency
FALIGN_COV_RTOL = 1e-3  # covariances at the same parameters
PGO_POSE_TOL = 1e-3  # positions and rotation entries, card vs the CPU run


def build_slam_scene(np, torch, n_flows):
    """The bench's full-SLAM scene (bench.py:240-298, out and back with a
    revisit, textured gray images), rendered with the port's so3_exp."""
    from synthetic import plane_depth, render_window

    from voldor_tpu_torch.ops.lie import so3_exp

    K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)

    def n_(v):
        v = np.asarray(v, np.float64)
        return v / np.linalg.norm(v)

    planes = [
        (n_([0.1, 0.15, 1.0]), 8.0),
        (n_([-0.35, 0.1, 1.0]), 6.5),
        (n_([0.3, -0.25, 1.0]), 7.0),
        (n_([0.5, 0.35, 1.0]), 7.5),
    ]
    rng = np.random.default_rng(11)
    half = n_flows // 2
    poses = np.zeros((n_flows, 6), np.float32)
    for f in range(n_flows):
        poses[f, :3] = rng.normal(0, 0.002, 3)
        sign = 1.0 if f < half else -1.0
        poses[f, 3:6] = [sign * 0.22, 0.01 * sign, 0.0]

    def r2R(rv):
        return so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy()

    flows, _, Ts = render_window(K, poses, planes, H, W, r2R)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(np.asarray(K, np.float64)).T
    images_bgri, images_grayf, depths = [], [], []
    for k in range(n_flows + 1):
        R, t = Ts[k][:3, :3], Ts[k][:3, 3]
        d = plane_depth(K, R, t, planes, H, W).astype(np.float64)
        Xw = (rays * d[..., None] - t) @ R
        t1 = np.sin(2.1 * Xw[..., 0]) * np.cos(1.7 * Xw[..., 1])
        t2 = np.sin(0.9 * Xw[..., 0] + 1.3 * Xw[..., 1] + 0.7 * Xw[..., 2])
        t3 = np.sin(3.7 * Xw[..., 0]) * np.sin(2.9 * Xw[..., 1])
        tex = 40.0 + 75.0 * (t1 > 0) + 60.0 * (t2 > 0.3) + 45.0 * (t3 > 0.2)
        g8 = np.clip(tex, 0, 255).astype(np.uint8)
        images_bgri.append(np.repeat(g8[..., None], 3, axis=-1))
        images_grayf.append(g8.astype(np.float32) / 255.0)
        depths.append(d.astype(np.float32))
    return dict(flows=flows, images_bgri=images_bgri, images_grayf=images_grayf, Ts=Ts,
                depths=depths, K=K)


@contextlib.contextmanager
def spying(module, name, seen):
    """Append what module.name returns to seen while inside."""
    real = getattr(module, name)

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def falign_batch(np, torch, sc, n_pairs, photo, seed=None):
    """A falign_pairs batch at the SLAM layer's local-link settings
    (voldor_tpu/slam/system.py:928-1091): keyframe pairs of the full-SLAM
    scene 5 and 10 frames apart, their true depths with 1% seeded noise
    (a VO depth map is never exact; on exact maps the sqrt-Cauchy
    robustifier passes every residual below FLT_EPSILON through and the
    Jacobians vanish) blurred at width 3, the gray images at width 5,
    seeded confidences, and the relative true pose as init with a small
    seeded error (seed 100 + n_pairs unless given); stride 4, coarse
    stride 6 and 12 fine iterations with images, vbf = 5 x basefocal,
    crw 10, 7-dof."""
    from voldor_tpu_torch.ops.image import gaussian_blur
    from voldor_tpu_torch.slam.slam_utils import T44_to_T6

    rng = np.random.default_rng(100 + n_pairs if seed is None else seed)
    starts = [0, 5, 10, 15, 20, 25, 30, 35]
    pairs = [(a, a + 5) for a in starts] + [(a, a + 10) for a in starts]
    pairs = pairs[:n_pairs]

    def blur(a, k):
        return gaussian_blur(torch.from_numpy(np.ascontiguousarray(a, np.float32)), k).numpy()

    D = np.stack([[blur(sc["depths"][f] * (1.0 + 0.01 * rng.standard_normal((H, W))), 3)
                   for f in p] for p in pairs])
    Wt = rng.uniform(0.5, 1.0, D.shape).astype(np.float32)
    inits = np.zeros((n_pairs, 2, 6), np.float32)
    for i, (a, b) in enumerate(pairs):
        rel = sc["Ts"][a] @ np.linalg.inv(sc["Ts"][b])  # cam b -> cam a
        inits[i, 1] = T44_to_T6(rel.astype(np.float32)) + rng.normal(0, [2e-3] * 3 + [1e-2] * 3)
    kw = dict(depths=D, fx=FX, fy=FY, cx=W / 2, cy=H / 2, weights=Wt, poses_init=inits,
              optimize_7dof=True, stride=4, vbf=BASEFOCAL * 5, crw=10)
    if photo:
        kw["images"] = np.stack([[blur(sc["images_grayf"][f], 5) for f in p] for p in pairs])
        kw["coarse_stride"] = 6
        kw["fine_iters"] = 12
    return pairs, kw


def _rel_poses(np, torch, poses_ret):
    from voldor_tpu_torch.ops.lie import pose6_to_T44

    T = pose6_to_T44(torch.as_tensor(poses_ret)).numpy().astype(np.float64)
    return np.linalg.inv(T[0]) @ T[1]


def _angle(np, Ra, Rb):
    """The angle (rad) of the rotation between Ra and Rb, stable when small."""
    return float(2.0 * np.arcsin(min(1.0, np.linalg.norm(Ra - Rb) / np.sqrt(8.0))))


def falign_lanes(np, torch, sc, pairs, card, cpu):
    """Per lane of two falign_pairs runs of one batch: iterations of each,
    the rotation angle and largest translation difference between their
    relative poses, and each run's rotation angle to the true relative
    pose (rad)."""
    out = []
    for (a, b), x, y in zip(pairs, card, cpu):
        truth = sc["Ts"][a] @ np.linalg.inv(sc["Ts"][b])
        Tx, Ty = _rel_poses(np, torch, x["poses_ret"]), _rel_poses(np, torch, y["poses_ret"])
        out.append(dict(
            pair=(a, b), iters=(x["iters_coarse"], x["iters"]), iters_cpu=(y["iters_coarse"], y["iters"]),
            iters_off=max(abs(x["iters_coarse"] - y["iters_coarse"]), abs(x["iters"] - y["iters"])),
            rot=_angle(np, Tx[:3, :3], Ty[:3, :3]), trans=float(np.abs(Tx[:3, 3] - Ty[:3, 3]).max()),
            truth_rot=_angle(np, Tx[:3, :3], truth[:3, :3]),
            truth_rot_cpu=_angle(np, Ty[:3, :3], truth[:3, :3])))
    return out


def phase_falign(np, torch, sc):
    """falign_pairs on the card against the same function on the CPU, four
    pairs, without and with images: per lane, the iterations, the relative
    rotation and translation within FALIGN_LIMITS of their kind, the
    card's rotation no more than FALIGN_TRUTH_ROT farther from the true
    one than the CPU's; the scale
    ratio within 1e-4 relative, the scores within FALIGN_SCORE_TOL, every
    solver tensor on the card, and the covariances the card computed
    against pair_covariances on the CPU at the card's parameters within
    FALIGN_COV_RTOL."""
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.falign import solver as fsolver

    real_body = fsolver.lm_body
    off_card = []

    def checked_body(prob, st, lanes, stride):
        for name, t in list(prob.maps._asdict().items()) + list(st._asdict().items()):
            if t.device.type != "cuda":
                off_card.append(name)
        return real_body(prob, st, lanes, stride)

    worst = dict(scale=0.0, score=0.0, cov=0.0)
    failed = []
    for photo in (False, True):
        kind = "photo" if photo else "geo"
        pairs, kw = falign_batch(np, torch, sc, 4, photo)
        solved = []
        fsolver.lm_body = checked_body
        try:
            with spying(falign_api, "solve_lanes", solved):
                card = falign_api.falign_pairs(**kw, device="cuda")
        finally:
            fsolver.lm_body = real_body
        cpu = falign_api.falign_pairs(**kw, device="cpu")
        if off_card:
            raise AssertionError(f"falign solver tensors off the card: {sorted(set(off_card))}")
        lanes = falign_lanes(np, torch, sc, pairs, card, cpu)
        for a, b in zip(card, cpu):
            ra = a["scaling_factor"][1] / a["scaling_factor"][0]
            rb = b["scaling_factor"][1] / b["scaling_factor"][0]
            worst["scale"] = max(worst["scale"], abs(ra / rb - 1.0))
            for k in ("visibility_mat", "consistency_mat"):
                worst["score"] = max(worst["score"], float(np.nanmax(np.abs(a[k] - b[k]))))
        # the covariance function on the CPU at the card's parameters
        cov_card = np.stack([a["poses_covar"] for a in card])
        cov_ref = cpu_covariances(np, torch, kw, solved[-1][0].cpu().numpy())
        denom = np.maximum(np.abs(cov_ref), 1e-12)
        diag = np.arange(7)
        cov_err = float((np.abs(cov_card - cov_ref)[..., diag, diag] / denom[..., diag, diag]).max())
        worst["cov"] = max(worst["cov"], cov_err)
        cov_indep = float((np.abs(cov_card - np.stack([b["poses_covar"] for b in cpu]))
                           [..., diag, diag] / denom[..., diag, diag]).max())
        lim = FALIGN_LIMITS[kind]
        for ln in lanes:
            log(f"[falign] {kind} lane {ln['pair']}: iterations (coarse, fine) card {ln['iters']} cpu "
                f"{ln['iters_cpu']} (limit {lim['iters']}); rotation {ln['rot']:.3e} rad (limit "
                f"{lim['rot']:.1e}), translation {ln['trans']:.3e} (limit {lim['trans']:.1e}); "
                f"rotation to the true pose card {ln['truth_rot']:.3e} cpu {ln['truth_rot_cpu']:.3e} "
                f"(limit cpu + {FALIGN_TRUTH_ROT:.0e})")
            if ln["iters_off"] > lim["iters"] or ln["rot"] > lim["rot"] or ln["trans"] > lim["trans"]:
                failed.append((kind, ln["pair"], "card vs cpu"))
            if ln["truth_rot"] > ln["truth_rot_cpu"] + FALIGN_TRUTH_ROT:
                failed.append((kind, ln["pair"], "rotation to the true pose"))
        log(f"[falign] {kind}: scale ratio {worst['scale']:.3e}, scores {worst['score']:.3e}; "
            f"covariance diagonals vs the CPU at the card's parameters {cov_err:.3e} relative "
            f"(vs the CPU's own solve {cov_indep:.3e}); consistency "
            f"{[round(float(np.nanmean(a['consistency_mat'])), 4) for a in card]}")
    if failed:
        raise AssertionError(f"falign lanes on the card outside their limits: {failed}")
    if worst["scale"] > 1e-4 or worst["score"] > FALIGN_SCORE_TOL or worst["cov"] > FALIGN_COV_RTOL:
        raise AssertionError(f"falign on the card disagrees with the CPU run: {worst}")
    return worst


def cpu_covariances(np, torch, kw, params):
    """pair_covariances on the CPU for the batch kw at params (P, 2, 9),
    as falign_pairs reports them (7-dof: the pose block and the scale)."""
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.falign.residual import precompute_maps
    from voldor_tpu_torch.falign.solver import pair_covariances

    P = params.shape[0]
    cpu = torch.device("cpu")
    shape = (P * 2, H, W)
    photo = "images" in kw
    maps = precompute_maps(falign_api._tensor(kw["depths"], cpu, shape),
                           falign_api._tensor(kw["weights"], cpu, shape),
                           falign_api._tensor(kw.get("images"), cpu, shape),
                           kw["fx"], kw["fy"], kw["cx"], kw["cy"])
    gauge = np.zeros((1, 18), np.float32)
    gauge[0, 6] = gauge[0, 15] = 1.0
    prob = falign_api._problem(maps, ((0, 1), (1, 0)), 2, kw["fx"], kw["fy"], kw["cx"], kw["cy"],
                               kw["vbf"], kw["crw"], photo, falign_api._dim_mask(2, True, photo),
                               gauge, cpu)
    cov, _ = pair_covariances(prob, torch.as_tensor(params), torch.arange(P), kw["stride"])
    cov = cov.numpy()
    out = np.zeros((P, 2, 7, 7), np.float32)
    out[..., :6, :6] = cov[..., :6, :6]
    out[..., 6, 6] = cov[..., 6, 6]
    return out


def circle_graph(np, torch, n, seed):
    """A drifted circle pose graph (tests/test_pgo.py's construction): exact
    relative measurements along the chain plus loop edges (0, n-1) and
    (0, n/2); the initial poses drift by a seeded random walk."""
    from voldor_tpu_torch.ops.lie import T44_to_pose6, pose6_to_T44

    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(n) / n
    gt = np.zeros((n, 7), np.float32)
    gt[:, 2] = a
    gt[:, 3], gt[:, 4] = 10.0 * np.cos(a), 10.0 * np.sin(a)
    T = pose6_to_T44(torch.as_tensor(gt[:, :6])).numpy().astype(np.float64)
    noisy = gt.copy()
    noisy[1:, 3:6] += rng.normal(0, 0.05, (n - 1, 3)).cumsum(0)
    noisy[1:, :3] += rng.normal(0, 0.01, (n - 1, 3)).cumsum(0)
    edges = np.asarray([[i, i + 1] for i in range(n - 1)] + [[0, n - 1], [0, n // 2]], np.int32)
    meas = np.zeros((len(edges), 7), np.float32)
    rel = np.linalg.inv(T[edges[:, 1]]) @ T[edges[:, 0]]
    meas[:, :6] = T44_to_pose6(torch.as_tensor(rel.astype(np.float32))).numpy()
    covar = np.tile((np.eye(7) * 1e-4).astype(np.float32), (len(edges), 1, 1))
    return noisy, edges, meas, covar


def _pose_err(np, torch, a, b):
    from voldor_tpu_torch.ops.lie import so3_exp

    R = [so3_exp(torch.as_tensor(np.asarray(x)[:, :3])).numpy() for x in (a, b)]
    return max(float(np.abs(a[:, 3:7] - b[:, 3:7]).max()), float(np.abs(R[0] - R[1]).max()))


def phase_pgo(np, torch):
    """pgo() on the card against the CPU at 60 and 600 poses (dense), then
    pgo_solve_jit (matrix-free CG) and pgo(reduce_threshold_dofs=0) (chain
    reduction): poses within PGO_POSE_TOL. Returns the largest error."""
    from voldor_tpu_torch.ops.lie import quat_to_rvec
    from voldor_tpu_torch.pgo import api as pgo_api
    from voldor_tpu_torch.pgo import solver as pgo_solver

    worst = 0.0
    for n in (60, 600):
        g = circle_graph(np, torch, n, seed=n)
        for kw in ({}, {"reduce_threshold_dofs": 0}):
            out, solves = {}, {}
            for dev in ("cuda", "cpu"):
                dense, cg, reduced = [], [], []
                with spying(pgo_api, "pgo_solve_dense_jit", dense), \
                        spying(pgo_api, "pgo_solve_jit", cg), \
                        spying(pgo_api, "chain_reduce", reduced):
                    out[dev] = pgo_api.pgo(*g, device=dev, **kw)
                solves[dev] = (("reduced to %d poses, " % len(reduced[0][0])) if reduced else "") + \
                    ", ".join(f"{name} {int(r[2])} LM iterations, cost {float(r[1]):.4e}"
                              for name, rs in (("dense", dense), ("cg", cg)) for r in rs)
            err = _pose_err(np, torch, out["cuda"], out["cpu"])
            worst = max(worst, err)
            log(f"[pgo] pgo() n={n} {kw or ''}: card {solves['cuda']}; cpu {solves['cpu']}; "
                f"poses max err {err:.3e}")
        # the CG path, called directly
        res = {}
        for dev in ("cuda", "cpu"):
            prob, _, _ = pgo_solver.build_problem(g[0], None, g[1], g[2], g[3], False,
                                                  torch.device(dev))
            sol, cost, iters = pgo_solver.pgo_solve_jit(prob)
            res[dev] = (np.concatenate([quat_to_rvec(sol.q).cpu().numpy(),
                                        sol.p.cpu().numpy(), sol.s.cpu().numpy()[:, None]], 1),
                        float(cost), int(iters))
        err = _pose_err(np, torch, res["cuda"][0], res["cpu"][0])
        worst = max(worst, err)
        log(f"[pgo] pgo_solve_jit (CG) n={n}: cost / iterations card {res['cuda'][1:]} cpu "
            f"{res['cpu'][1:]}; poses max err {err:.3e}")
    if worst > PGO_POSE_TOL:
        raise AssertionError(f"PGO on the card disagrees with the CPU run ({worst:.3e})")
    return worst


def profile_counts(torch, fn):
    """(kernel launches, stream/device syncs, device-to-host copies) of one
    call of fn, from torch.profiler's runtime events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = {e.key: e.count for e in prof.key_averages()}
    launches = sum(v for k, v in n.items() if k.startswith("cudaLaunchKernel"))
    syncs = sum(v for k, v in n.items() if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                                   "cudaEventSynchronize"))
    copies = n.get("cudaMemcpyAsync", 0)
    return launches, syncs, copies


def phase_mapping_times(np, torch, sc):
    """falign_pairs per call and per LM iteration at 4 and 16 pairs (with
    images, the local-link settings), with its launches and host syncs;
    PGO dense and CG per solve at 60 and 600 poses."""
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.falign import solver as fsolver
    from voldor_tpu_torch.pgo import solver as pgo_solver

    out = {}
    real_body = fsolver.lm_body
    for n_pairs in (4, 16):
        _, kw = falign_batch(np, torch, sc, n_pairs, True)
        falign_api.falign_pairs(**kw, device="cuda")  # warm
        bodies = [0]

        def counted(*a, **k):
            bodies[0] += 1
            return real_body(*a, **k)

        times = []
        fsolver.lm_body = counted
        try:
            for _ in range(3):
                bodies[0] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rets = falign_api.falign_pairs(**kw, device="cuda")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            fsolver.lm_body = real_body
        chunks = []  # one read of the done flags per chunk of LM iterations
        with spying(fsolver, "lm_iterate", chunks):
            launches, syncs, copies = profile_counts(
                torch, lambda: falign_api.falign_pairs(**kw, device="cuda"))
        call = statistics.median(times)
        lane_its = sum(r["iters"] + r["iters_coarse"] for r in rets)
        out[n_pairs] = dict(call_s=call, per_iter_ms=call / bodies[0] * 1e3, batch_iters=bodies[0],
                            lane_iters=lane_its, launches=launches, syncs=syncs, copies=copies,
                            host_reads=len(chunks))
        log(f"[times] falign_pairs {n_pairs} pairs (photo + geo, 7-dof, stride 4, coarse 6): "
            f"{call:.4f} s per call (median of 3: {[round(t, 4) for t in times]}), "
            f"{bodies[0]} batched LM iterations ({lane_its} lane iterations), "
            f"{call / bodies[0] * 1e3:.3f} ms per batched iteration; per call {launches} kernel "
            f"launches, {syncs} host syncs, {copies} memcpys, {len(chunks)} done-flag reads")
    for n in (60, 600):
        g = circle_graph(np, torch, n, seed=n)
        prob, _, _ = pgo_solver.build_problem(g[0], None, g[1], g[2], g[3], False,
                                              torch.device("cuda"))
        for name, solve in (("dense", pgo_solver.pgo_solve_dense_jit), ("cg", pgo_solver.pgo_solve_jit)):
            solve(prob, max_iters=2)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cost, iters = solve(prob)
            iters = int(iters)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            out[f"pgo_{name}_{n}"] = dict(solve_s=dt, iters=iters)
            log(f"[times] PGO {name} n={n}: {dt:.4f} s per solve, {iters} LM iterations, "
                f"{dt / max(iters, 1) * 1e3:.3f} ms per iteration, cost {float(cost):.4e}")
    return out


def make_full_slam(sc):
    """VOLDOR_SLAM(mode="mono") configured as bench.py:_make_slam_e2e
    (:301-321), without enable_loop_closure (ORB retrieval needs cv2)."""
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    slam = VOLDOR_SLAM(mode="mono", device="cuda")
    slam.set_cam_params(FX, FY, W / 2, H / 2)
    flows = sc["flows"]
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = flows.shape[0]
    slam.images_bgri = list(sc["images_bgri"])
    slam.images_grayf = list(sc["images_grayf"])
    slam.image_loader_pt = len(sc["images_bgri"])
    slam.lc_min_kf_distance = 3
    return slam


def _overlap(intervals, others):
    """Seconds of intervals that fall inside the union of others."""
    tot = 0.0
    for a0, a1 in intervals:
        for b0, b1 in others:
            tot += max(0.0, min(a1, b1) - max(a0, b0))
    return tot


def run_full_slam(np, torch, sc, check=False):
    """One pass of vo_thread + mapping_thread, joined with a timeout as
    bench.py:_run_slam_once does. Returns (slam, wall s, stats)."""
    import threading

    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.pgo import api as pgo_api

    slam = make_full_slam(sc)
    events, spans, dispatched = [], {"falign": [], "pgo": [], "vo": []}, []
    slam.metrics.log = lambda event, **kw: events.append(dict(event=event, **kw))

    def spanned(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans[name].append((t0, time.perf_counter()))
        return wrapper

    real = {"falign": falign_api.falign_pairs, "pgo": pgo_api.pgo}
    falign_api.falign_pairs = spanned("falign", real["falign"])
    pgo_api.pgo = spanned("pgo", real["pgo"])
    slam.process_vo = spanned("vo", slam.process_vo)
    dispatch = slam._vo_dispatch

    def counting_dispatch(inputs):
        handle = dispatch(inputs)
        dispatched.append(handle)
        return handle

    slam._vo_dispatch = counting_dispatch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vo = threading.Thread(target=slam.vo_thread, daemon=True)
        mp = threading.Thread(target=slam.mapping_thread, daemon=True)
        vo.start()
        mp.start()
        vo.join(timeout=600)
        mp.join(timeout=600)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        falign_api.falign_pairs, pgo_api.pgo = real["falign"], real["pgo"]
    alive = vo.is_alive() or mp.is_alive()
    links = [e for e in events if e["event"] == "local_link"]
    pgos = [e for e in events if e["event"] == "pgo"]
    busy = {k: sum(b - a for a, b in v) for k, v in spans.items()}
    mapping = spans["falign"] + spans["pgo"]
    st = dict(
        alive=alive, keyframes=list(slam.kf_ids), links=len(links),
        accepted=sum(1 for e in links if e["accepted"]),
        rejected_cv=sum(1 for e in links if e["rejected_by"] == "consistency/visibility"),
        rejected_rank=sum(1 for e in links if e["rejected_by"] == "covar_rank"),
        pgo=[(e["fid_start"], e["n_frames"], e["n_edges"], e["solve_s"]) for e in pgos],
        falign_calls=len(spans["falign"]), falign_s=busy["falign"], pgo_s=busy["pgo"],
        vo_s=busy["vo"], overlap_s=_overlap(mapping, spans["vo"]),
        edges={t: sum(1 for e in slam.edges if e.edge_type == t)
               for t in sorted({e.edge_type for e in slam.edges})},
        em_iters=sum(int(h.engine._st_scalars[1]) for h in dispatched),
    )
    if check:
        if alive:
            raise AssertionError("slam-full-mono: a thread is still alive after the join")
        if len(slam.frames) != sc["flows"].shape[0] + 1:
            raise AssertionError(f"slam-full-mono: {len(slam.frames)} frames")
        if not all(np.isfinite(f.Tcw).all() for f in slam.frames):
            raise AssertionError("slam-full-mono: a frame pose is not finite")
        if st["edges"].get("falign-local", 0) < 1:
            raise AssertionError("slam-full-mono: no falign-local edge was accepted")
        if not pgos or pgos[-1]["fid_start"] != 0:
            raise AssertionError("slam-full-mono: the final global PGO did not run")
    return slam, dt, st


def phase_full_slam(np, torch, sc):
    """slam-full-mono: one checked pass with the kernels' launches counted,
    one timed pass, and a VO-only pass (process_vo alone) for comparison.
    Returns (launch counts, frames/s of the timed pass, ATE)."""
    from voldor_tpu_torch.utils.evaluation import ate_rmse

    gt = np.linalg.inv(sc["Ts"])
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    n_frames = sc["flows"].shape[0] + 1

    def ate_of(slam):
        return ate_rmse(np.stack([f.Tcw for f in slam.frames]).astype(np.float64), gt,
                        with_scale=True)

    reset_counts()
    slam, dt0, st = run_full_slam(np, torch, sc, check=True)
    counts = read_counts()
    ate = ate_of(slam)
    log(f"[slam-full-mono] checked pass: {n_frames} frames in {dt0:.4f} s ({n_frames / dt0:.4f} "
        f"frames/s); keyframes {len(st['keyframes'])} {st['keyframes']}; local links tried "
        f"{st['links']}, accepted {st['accepted']}, rejected by consistency/visibility "
        f"{st['rejected_cv']}, by covariance rank {st['rejected_rank']}; edges {st['edges']}; PGO "
        f"solves (fid_start, n_frames, n_edges, solve_s) {st['pgo']}; falign calls "
        f"{st['falign_calls']}; EM iterations {st['em_iters']}, cost kernel launches "
        f"{counts['cost']} ({counts['score']} in score mode), fb_smooth launches {counts['fb']}")
    log(f"[slam-full-mono] Sim3 ATE {ate:.6f} vs gate {0.02 * extent:.6f} (extent {extent:.4f})")
    check_counts("slam-full-mono", counts, st["em_iters"])
    if not ate < 0.02 * extent:
        raise AssertionError("slam-full-mono: trajectory fails the Sim3-ATE gate")

    slam, dt, st = run_full_slam(np, torch, sc)
    ate_t = ate_of(slam)
    log(f"[slam-full-mono] timed pass: {n_frames / dt:.4f} frames/s ({dt:.4f} s); falign "
        f"{st['falign_s']:.4f} s in {st['falign_calls']} calls ({100 * st['falign_s'] / dt:.1f}% "
        f"of the wall), PGO {st['pgo_s']:.4f} s in {len(st['pgo'])} solves "
        f"({100 * st['pgo_s'] / dt:.1f}%), VO windows {st['vo_s']:.4f} s "
        f"({100 * st['vo_s'] / dt:.1f}%); mapping work inside VO windows {st['overlap_s']:.4f} s "
        f"({100 * st['overlap_s'] / max(st['falign_s'] + st['pgo_s'], 1e-9):.1f}% of it); "
        f"keyframes {len(st['keyframes'])}, links {st['accepted']}/{st['links']} accepted, PGO "
        f"{st['pgo']}; Sim3 ATE {ate_t:.6f}")
    if st["alive"] or not ate_t < 0.02 * extent:
        raise AssertionError("slam-full-mono: the timed pass fails")

    vo_only = make_full_slam(sc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while vo_only.process_vo():
        pass
    torch.cuda.synchronize()
    dt_vo = time.perf_counter() - t0
    log(f"[slam-full-mono] VO-only pass (process_vo alone, for comparison): "
        f"{n_frames / dt_vo:.4f} frames/s, Sim3 ATE {ate_of(vo_only):.6f}; the mapped pass "
        f"{ate_t:.6f}")
    return counts, n_frames / dt, ate


def main():
    import numpy as np
    import torch

    smi = phase_device(torch)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import voldor_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from voldor_tpu_torch.utils.evaluation import ate_rmse
    from voldor_tpu_torch.vo import engine as engine_mod

    phase_build()
    sass = sass_counts()

    # the bench's 24-flow scene; the VO windows take its first 15 flows
    # (the pose draws are sequential, so they are the same)
    scene = build_scene(np, torch, SLAM_FLOWS)
    bi = bench_inputs(np, torch, scene)
    fb_err = phase_fb(np, torch, bi)
    score_err = phase_score(np, torch, bi)
    accept_frac = phase_accept(np, torch, bi)
    fb_rec, cost_rec = phase_times(np, torch, bi, sass)

    # the slice, counted: every launch from here on is the main path's
    reset_counts()
    est, walls0, iters, route = run_sequence(np, torch, scene, check=True)
    win_counts = read_counts()
    log(f"[slice] bootstrap route: {route}; EM iterations per window {iters}; "
        f"cost kernel launches {win_counts['cost']} ({win_counts['score']} in score mode), "
        f"fb_smooth kernel launches {win_counts['fb']}; cold wall s {[round(x, 4) for x in walls0]}")
    check_counts("windows", win_counts, sum(iters))
    gt = np.linalg.inv(scene[5][:N_WINDOWS * WINDOW + 1])  # cam -> world, frames 0..15
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    ate = ate_rmse(est.astype(np.float64), gt, with_scale=True)
    log(f"[slice] Sim3 ATE {ate:.6f} vs gate {0.02 * extent:.6f} (extent {extent:.4f})")
    if not ate < 0.02 * extent:
        raise AssertionError("trajectory fails the Sim3-ATE gate")

    phase_no_sync(np, torch, scene)

    reps = [run_sequence(np, torch, scene)[1] for _ in range(3)]
    med = [statistics.median(r[i] for r in reps) for i in range(N_WINDOWS)]
    log(f"[times] window wall s (median of 3, warm; 0/1/2 priors): {[round(x, 4) for x in med]}")

    # fb_smooth's share of one window: synchronized timers around its calls
    fb_time = [0.0]

    def timed(fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            fb_time[0] += time.perf_counter() - t
            return out
        return wrapper

    # every fb_smooth call of a depth round goes through this one name
    # (fb_smooth_masked calls it too)
    orig = engine_mod.fb_smooth
    engine_mod.fb_smooth = timed(orig)
    try:
        _, walls_fb, _, _ = run_sequence(np, torch, scene)
    finally:
        engine_mod.fb_smooth = orig
    log(f"[times] fb_smooth over the 3 windows: {fb_time[0]:.4f} s of {sum(walls_fb):.4f} s "
        f"({100.0 * fb_time[0] / sum(walls_fb):.1f}%)")

    # the SLAM layer on the card: mono, then stereo with disparity
    # bf / depth (bench.py:116-154)
    from synthetic import plane_depth

    K, planes, _, flows, _, Ts, _ = scene
    gt = np.linalg.inv(Ts)  # cam -> world, frames 0..24
    mono, fps_mono, ate_mono = phase_slam(np, torch, "mono", flows, gt, n_timed=1)
    disps = [(BF_STEREO / plane_depth(K, Ts[k][:3, :3], Ts[k][:3, 3], planes, H, W)).astype(np.float32)
             for k in range(SLAM_FLOWS)]
    stereo, fps_st, ate_st = phase_slam(np, torch, "stereo", flows, gt, disps=disps, n_timed=1)
    log(f"[slam] mono {fps_mono:.4f} frames/s (Sim3 ATE {ate_mono:.6f}), stereo {fps_st:.4f} "
        f"frames/s (metric ATE {ate_st:.6f}); launches cost / fb_smooth: windows "
        f"{win_counts['cost']} / {win_counts['fb']}, mono pass {mono['cost']} / {mono['fb']}, "
        f"stereo pass {stereo['cost']} / {stereo['fb']}")

    # the mapping half: falign and PGO against their CPU runs, their times,
    # then the full SLAM pass (VO + mapping thread) on the bench's scene
    sc = build_slam_scene(np, torch, SLAM_E2E_FLOWS)
    falign_err = phase_falign(np, torch, sc)
    pgo_err = phase_pgo(np, torch)
    mapping_times = phase_mapping_times(np, torch, sc)
    full, fps_full, ate_full = phase_full_slam(np, torch, sc)
    log(f"[mapping] falign card vs CPU {falign_err}; PGO card vs CPU {pgo_err:.3e}; slam-full-mono "
        f"{fps_full:.4f} frames/s (Sim3 ATE {ate_full:.6f}) beside slam-mono {fps_mono:.4f}; "
        f"launches cost / fb_smooth on the full pass {full['cost']} / {full['fb']}; "
        f"times {json.dumps(mapping_times)}")
    paths = (win_counts, mono, stereo, full)

    log(f"[device] {smi}")
    log(json.dumps({"kernels": [
        {
            "name": "fb_smooth",
            "route": "cuda",
            "source": "voldor_tpu_torch/csrc/fb_smooth_kernel.cu",
            "replaces": "voldor_tpu/ops/fb_smooth.py:134",
            "launches": sum(c["fb"] for c in paths),
            "max_abs_err": fb_err,
            "ms": fb_rec["ms"],
            "plain_ms": fb_rec["plain_ms"],
            "bound_ms": fb_rec["bound_ms"],
            "bound_us": fb_rec["bound_ms"] * 1e3,
            "bound_by": fb_rec["bound_by"],
            "library_ms": None,
            "chain_floor_us": fb_rec["chain_floor_ms"] * 1e3,
            "chain_step_pair_ns": fb_rec["chain_step_pair_ns"],
            "ms_m2": fb_rec["ms_m2"],
        },
        {
            "name": "cost_map_tracked",
            "route": "cuda",
            "source": "voldor_tpu_torch/csrc/cost_kernel.cu",
            "replaces": "voldor_tpu/ops/pallas_cost.py:33",
            "launches": sum(c["cost"] for c in paths),
            "score_launches": sum(c["score"] for c in paths),
            "max_abs_err": score_err,
            "accept_agreement": accept_frac,
            "ms": cost_rec["ms"],
            "plain_ms": cost_rec["plain_ms"],
            "bound_ms": cost_rec["bound_ms"],
            "bound_us": cost_rec["bound_ms"] * 1e3,
            "bound_by": cost_rec["bound_by"],
            "library_ms": None,
            "score_ms": cost_rec["score_ms"],
            "ms_by_k": cost_rec["ms_by_k"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
