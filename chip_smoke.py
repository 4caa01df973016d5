#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

With --parent DIR (a checkout of another commit, e.g. the parent unpacked
from git archive), phase 6 also times that checkout's fb_smooth kernel and
cost kernel beside this one's, through tools/fb_smooth_ab.py and
tools/cost_kernel_ab.py (each checkout's own wrappers, in processes of
their own), with the other cost kernel's issue-rate floor.

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA device must be present (never falls back to the CPU);
   prints the card's name and power limit from nvidia-smi;
2. build: compiles every hand-written kernel source
   (voldor_tpu_torch/csrc/*.cu, one nvcc each, in parallel) into one
   library in voldor_tpu_torch/_build/; prints ptxas's registers and the
   SASS instruction count of every kernel;
3. fb_smooth vs plain: the kernel against fb_smooth_reference on the card
   at (M, 185, 613), M in {5, 3, 2, 1}, on the bench scene's rigidness
   maps, and on seeded uniform stacks whose lines are shorter than a chunk
   or not a multiple of it (h or w of 1, 37, 61): max abs error within
   1e-5; beside it, the error against fb_smooth_chunked_reference (the
   kernel's own arithmetic in plain torch), printed;
4. cost kernel, score mode vs plain: the normalised costs against the plain
   composition at the main path's shapes (185x613, N=5, K in {1,4,10,16},
   D in {0,1,2,3} -- D=3 with the stereo disparity slot --, active_n in
   {5,3}), at wider ones (COST_WIDE_CASES: N of 1 and 8, D of 4, windows
   cut short) and at the demo's default abs_resize_factor 0.5 (K=10, N=5,
   D=2): two launches bitwise equal, identical +inf pattern, finite values
   within rtol = atol = 1e-5;
5. cost kernel, accept mode vs plain: a random (K=10), a global (K=4) and a
   jump (K=4) proposal batch at N=5, D=2, and a K=16 batch at N=8, D=4
   with 30% of its candidates masked: the accepted depth equals the
   plain composition's at >= 99.9% of pixels; the written cost equals the
   plain one (+inf pattern identical, within 1e-5 + 1e-5 relative) where
   the depths agree, and everywhere the plain cost of the kernel's own
   pick, which at a differing pixel is within 1e-5 relative of the plain
   pick's (a near-tie);
5b. the pose sweep's kernels vs plain: the first window of the bench scene
   through voldor_dispatch on the card, its first _solve_and_fuse call of
   each batch size recorded (B = 1: the sequential sweep; B = 5: the Jacobi
   sweep; S = 8192 hypotheses over the M correspondences the obs collect
   gives at 613x185) and the KITTI ground fit's 4-D pool of its depth;
   on draws from seeded generators, the P4P kernel against
   solve_batch_p4p_reference (ok flags equal on >= 99.9% of the
   hypotheses; where both are ok, rvec and t within 1e-4 on >= 99% and
   within 1e-3 on all; the pool output equal to [rvec * scale, t]), the
   meanshift kernel against meanshift_reference on the kernel's pool with
   the external start off and on and on the ground pool (equal iteration
   counts, mean and confidence within rtol = atol = 1e-5), the
   robust-Gaussian kernel against fit_robust_gaussian_reference as
   _solve_and_fuse calls it (equal iterations and reliability, mean
   within rtol 1e-5 / atol 1e-4, covariance within rtol 1e-4 / atol 1e-4,
   density within 1e-6 relative); each kernel bitwise equal on two
   launches; then the pose-path A/B: phase 7's three windows with the
   kernels and with the plain fuse (the plain versions patched into
   vo/pose_step.py) from the same seeds, their pose differences, walls and
   Sim3 ATEs under the gate, and the kernel launches and syncs of one
   fuse call each way (torch.profiler);
5c. the chain trace kernel vs plain: the kernel of ops/chain_trace.py, with
   and without the track planes, against its plain version on the card
   (chain_trace_reference) at the bench window (185x613, N = 5) on
   CHAIN_CASES (its frame-0 depth, jittered, cut short at 3 frames, points
   behind the camera, tracks that leave at every edge, depths of 1e38 that
   give NaN positions, +inf and NaN depths): track planes and in-bounds bitwise equal, rigidness NaN where
   NaN and within CHAIN_RIG_ATOL (its bitwise share printed), the
   rigidness-only launch and a repeat bitwise equal;
5d. the pose collect kernel vs plain: the kernel of ops/pose_collect.py in
   both modes against the plain collects of vo/pose_step.py on the card at
   the bench window (185x613, N = 5) over COLLECT_VARIANTS (the frame-0
   depth with NaN, +inf, negative, too near and too far patches; poses that
   carry the traces off the map; the rigidness-sum test on; the far-depth
   test off; the anchored tracks of the chain trace in place of the
   observed ones), strides 1 and 2 and max_trace_on_flow 0, 1 and 3: the
   traced collect at every target, the obs collect at every active_n with
   the in-bounds flags false over a patch from frame 2 on; p2, p3 and
   valid bitwise equal, a repeat launch bitwise equal;
6. device-only times (CUDA events around 100 back-to-back launches of the
   bound C call, no wrapper in between) of the fb_smooth kernel and the
   cost kernel in score mode and in accept mode with and without masks
   (COST_SHAPES) at K = 1, 4, 10, 16, beside their
   plain versions and their bounds: the larger of the bytes over 3.35 TB/s
   and the least operations of the function on this run's data (counted
   from its plain formula, see least_ops) over the peak FP32 and
   special-function rates; the cost kernel's launch geometry (the entry
   point's held to ops/cost.py:geometry), registers, spills, resident warps
   per SM and waves per launch, and its issue-rate floor (its own SASS
   instructions per term, from the term probes' builds, at the FP32 issue
   rate), and
   whether torch.pow(v, -2.0) on the card is bitwise 1 / (v * v) (the
   kernel's premise); fb_smooth's serial floor (the latency of one
   forward and one backward step, timed on one thread, times h + w), the
   chunked design's chain floor (compositions and steps per line pass,
   each timed on one thread) and, with --parent, the other checkout's
   kernel; then, on the full-SLAM scene of phase 12, the falign kernels at
   the 4-pair photometric batch (stride 4) and the loop-closure batch
   (stride 3): the one-shot linearise launch and its scores mode, and the
   LM chunk kernel over a chunk of 8 from the phase start (per launch and
   per batched iteration, clusters of 8 and of 16 blocks), beside their
   plain versions and bounds (the linearise kernel's bytes sector by
   sector, its operations counted from its plain formula, FALIGN_PX; the
   chunk's chain floor, each piece timed by falign_chain_probe_kernel), and
   two yardsticks the port never calls: one torch.bmm of the plain
   Jacobians' Gram matrices, and torch.linalg.cholesky_ex +
   torch.cholesky_solve on the lanes' damped 18 x 18 systems; and the
   pose kernels at phase 5b's shapes (B = 5 and B = 1): P4P, meanshift and
   the robust Gaussian as bound C calls beside their plain versions, their
   bounds (the bytes the function must move; the operations counted from
   the plain formula, P4P_PIECE, ms_piece, RG_ESTEP / RG_MSTEP, per
   iteration times the iterations run) and, for meanshift and the robust
   Gaussian, their chain floors (one block sum per step, timed on one block
   by pose_reduce_probe_kernel, times the steps of the longest search);
   and the chain trace kernel at N = 5 with and without the track planes
   at 128 and 256 threads a block, beside its bound (bytes; CT_PIECES) and
   its registers, and update_rigidness_and_tracks through the wrapper
   beside the plain composition it replaced (host ms a call, dispatched
   without synchronising, and event ms a call); and the pose collect
   kernel in both modes at the sweeps' shapes (obs: active_n = 5; traced:
   the last target) beside its bound (bytes) and its registers, and a
   collect through the wrapper beside the plain collect (host ms and event
   ms a call);
7. the VO windows: three consecutive 5-flow mono VO windows of the bench
   scene (613x185, seed 7) through voldor_tpu_torch's VO entry point on the
   card, with 0, 1 and 2 depth priors and the SLAM layer's constant-velocity
   warm start; each window must register 5 transitions, every engine
   tensor must lie on the card, the cost kernel must have been launched at
   least 8 times per flow-fed EM iteration, the chain trace kernel at least
   once per EM iteration and the fb_smooth kernel at least once, and the
   16-frame trajectory must pass the bench's gate, Sim3 ATE < 0.02 * scene
   extent; the cost kernel's launches by shape
   (mode, K, masks) and by depth round weight phase 6's times into a
   flow-fed round's cost time (and, with --parent, each checkout's);
8. no host sync: the same three windows with every call of the kernel
   wrappers (fb_smooth, cost score, cost accept, the chain trace through
   em.update_rigidness_and_tracks, the pose collect) and of the pose
   sweep's _solve_and_fuse (its three kernels and the draws between them)
   run under torch.cuda.set_sync_debug_mode("error");
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
   the SLAM layer's local-link settings, without and with images, and one
   loop-closure batch of its four revisit pairs at the loop-closure
   settings (kind="lc": stride 3, depth blur 5, image blur 9, depth medians
   normalised to 10, identity init, geometry stage then photometric), on
   the card and on the CPU: per lane, the iteration counts, the angle
   between the relative rotations and the difference of the translations
   within FALIGN_LIMITS of the batch's kind (geo, photo, lc; the lc lanes'
   iterations not held), the card's rotation no farther from the true
   relative rotation than the CPU's by more than the kind's limit; every
   solver tensor on the card, scale ratios
   and scores within the kind's limits, and the card's covariances
   within FALIGN_COV_RTOL of pair_covariances on the CPU at the card's
   parameters; and bilinear sampling at a NaN coordinate on the card gives
   NaN; then the falign kernels against their plain versions on the card
   (the geo, photo and lc batches at strides 3, 4 and 6: the linearise
   kernel's per-pair blocks within FALIGN_BLOCK_RTOL of each block's
   largest entry, its scores mode's visible pixels equal, two launches
   bitwise equal; the LM chunk kernel against the plain chunk from the
   same state, one step, a second, a chunk of 8, rejected steps, a failed
   Cholesky factor, frozen lanes, and falign() lanes of three frames
   without gauge rows (the warp factor at D = 27), four frames and twenty
   frames (the block-wide factor): the parameters within FALIGN_STEP_RTOL
   of the largest move, the rest of the state within FALIGN_BLOCK_RTOL,
   iteration counts and done flags equal; every step's backward error
   against its system, in float64, within D 2^-24), a chunk of 8 bitwise
   equal to eight chunks of one,
   a chunk twice (bitwise equal) and under set_sync_debug_mode("error"),
   and wrong inputs refused (a CPU tensor, wrong shapes and types, a lane
   too large for shared memory, a cluster the device cannot hold);
13. PGO: drifted circle graphs with loop edges at 60 and 600 poses through
   pgo() and pgo(reduce_threshold_dofs=0) (chain reduction), on the card
   and on the CPU: poses within PGO_POSE_TOL; then pgo() with poses_idx
   (the SLAM's call) on the card at 600, 1,100 and 4,541 poses: the cost
   and the poses against the plain float64 LM of benchmark/reference_map.py
   within the mapped drive's limits, the time of an LM iteration and the
   peak device memory;
14. mapping times: falign_pairs per call and per batched LM iteration at 4
   and 16 pairs with its kernel launches and host syncs (torch.profiler),
   the 4-pair call split into set-up (maps, phase starts), chunks and
   finish (synchronised timers), the launches of one chunk of 8 LM
   iterations alone (at most one per iteration, and at most 37 host syncs
   per 4-pair call), the dense PGO per solve at 60 and 600 poses;
15. slam-full-mono: the full-SLAM scene through VOLDOR_SLAM(mode="mono",
   device="cuda") configured exactly as bench.py:_make_slam_e2e, with
   enable_loop_closure() (the built-in vocabulary), vo_thread and
   mapping_thread as two threads; one checked pass (threads joined, finite
   poses, >= 1 accepted falign-local edge, >= 1 loop-closure candidate,
   lc_link event and falign-lc edge, a global PGO after the first LC link,
   the kernels' launches, every falign kernel launched, Sim3 ATE < 0.02 *
   extent), one timed pass
   (frames/s, the share of the wall in falign and in PGO, how much of the
   mapping work overlaps the VO windows, the host seconds of append_kf's
   loop-closure work split into ORB, retrieval with its refits and the
   geometry check, the LC decisions, cv2's version), and one timed pass
   with loop closure off beside it;
16. the demo CLI at the users' size: the full-SLAM scene rendered at
   KITTI's 1226x370 (fx = fy = 700, principal point at the centre), its
   60 flows as .flo files and 61 PNG images in a directory of the checkout,
   run through `python -m voldor_tpu_torch.demo --mode mono` (default
   --resize 0.5, so abs_resize_factor 0.5) with --enable_mapping
   --enable_loop_closure --save_poses --save_map --metrics in a child
   process; it must exit 0, write 61 poses that pass the Sim3-ATE gate,
   launch every kernel (the falign kernels included), its flow loader
   must have taken the native prefetcher (it prints
   "(native IO)"), and its map must load (checkpoint.load_map) into a new
   VOLDOR_SLAM with the same poses; beside it, the seconds to read the 60
   .flo files through the native prefetcher and through the Python reader
   (twice each, alternating; the arrays must be equal);
17. mono-scaled: phase 11's scene and disparities through
   VOLDOR_SLAM(mode="mono-scaled", device="cuda") with basefocal = bf
   (bench.py:run_stereo): one checked pass under the bench's gate for the
   mode (metric ATE < 0.05 * extent), then one timed pass;
18. slam-mono reference-exact: the JAX package's golden oracle
   (tests/test_parity.py:45-49: sequential sweep, traced collect, projected
   cost, full-grid pool, per-round prior sampling) appended to phase 10's
   configuration, over the same 24 flows at 613x185: one checked pass
   (the cost kernel never launched, fb_smooth launched, the projected
   cost's calls timed behind synchronised timers for its share of the
   pass, Sim3 ATE < 0.02 * extent), one timed pass (frames/s), and a
   pass of the shipped defaults held to tests/test_parity.py's clean
   limits of it (mutual Sim3 ATE / extent < 0.02, median gauge-normalised
   keyframe-depth deviation < 0.05); the oracle's sibling options
   (--lambdatwist 0, --depth_local_prop_mode exact with the projected cost,
   the hybrid sweep with the traced collect), each over the first two
   5-flow windows under the gate; save_result of one window engine with
   --save_everything --kitti_estimate_ground 1 (the file set, depth.npy
   equal to the engine's depth, a finite ground estimate), and a
   VOLDOR_SLAM pass over 15 flows with debug_dir (every window's files).

The kernels' launch counts sum the main-path phases (7, 10, 11, 15, 16, 17
and 18; phase 16's child process prints its own counts). Every VO phase must
launch each of the pose sweep's three kernels and its collect kernel
(check_pose_counts). The falign kernels run
on the mapping half only: their launches are those of phases 15 and 16
(the full pass's checked pass and the CLI's child), by path in the record.
The second-to-last line of stdout is a JSON record of the kernels; the
last line is {"ok": true, "device": {...}}. A run that has not ended
after STALL_S seconds prints every thread's stack and exits 1.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import faulthandler
import inspect
import json
import math
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
STALL_S = 900  # seconds after which a run that has not ended is a stall


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
    m = re.search(r"cost_kernelILi(\d+)ELb([01])E", mangled)  # an older checkout's thread-per-pixel kernel
    if m:
        return f"cost_kernel<KT={m.group(1)}, {'accept' if m.group(2) == '1' else 'score'}>"
    m = re.search(r"cost_kernelILb([01])E", mangled)
    if m:
        return f"cost_kernel<{'accept' if m.group(1) == '1' else 'score'}>"
    m = re.search(r"cost_term_probe_kernelILi(\d)ELi(\d)E", mangled)
    if m:
        return f"cost_term_probe<{m.group(1)},{m.group(2)}>"
    m = re.search(r"chain_trace_kernelILb([01])E", mangled)
    if m:
        return f"chain_trace_kernel<{'tracks' if m.group(1) == '1' else 'rigidness'}>"
    m = re.search(r"falign_linearize_kernelILb([01])E", mangled)
    if m:
        return f"falign_linearize_kernel<{'scores' if m.group(1) == '1' else 'grads'}>"
    m = re.search(r"(meanshift_kernel|pose_reduce_probe_kernel)ILi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    m = re.search(r"(fb_rows_kernel|fb_cols_kernel|fb_chain_probe_kernel|fb_combine_probe_kernel|"
                  r"falign_lm_chunk_kernel|falign_chain_probe_kernel|p4p_kernel|"
                  r"robust_gaussian_kernel)", mangled)
    return m.group(1) if m else mangled


def sass_counts(library=None, quiet=False):
    """Static SASS instruction count of every kernel in the library (this
    tree's, or the one at path `library`)."""
    from voldor_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library or _build.library_path())],
                          check=True, capture_output=True, text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    counts = {short_name(name): len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[A-Z@]", body))
              for name, body in zip(parts[1::2], parts[2::2])}
    for name, n in counts.items():
        if not quiet:
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


def planes_at(bi, active_n, D, stereo=False, p=None):
    """(rig, track, tinb), prior samples of D priors, at active_n frames
    (with the parameters p, the bench's by default)."""
    from voldor_tpu_torch.vo import em

    p = bi["p"] if p is None else p
    rig = em.update_rigidness(bi["d0"], bi["fl"], bi["Rs"], bi["ts"], active_n, p).contiguous()
    track, tinb = em.precompute_obs_tracks(bi["fl"], active_n, p)
    ps = None
    if D:
        ps = em.precompute_prior_samples(
            bi["d0"], bi["priors"][:D], bi["pconfs"][:D], bi["confs"][:D], bi["dp_Rs"][:D],
            bi["dp_ts"][:D], p._replace(disp_delta=1.0) if stereo else p,
        )
    return rig, track, tinb, ps


def cost_cands(bi, k):
    """K candidate maps of the bench scene: the first k of bench_inputs'
    ten, and at K = 16 six of them again, scaled by 1.03."""
    import torch

    ca = bi["cands_all"]
    return (ca[:k] if k <= ca.shape[0] else torch.cat([ca, ca[1:k - 9] * 1.03])).contiguous()


def wide_planes(scene, bi, n, D, active_n):
    """(planes, prior samples) of an n-frame window of the bench scene
    (n up to 8) with D priors (up to 4: bench_inputs' three, and the
    frame-0 depth x 0.97 at the identity pose)."""
    import torch

    from voldor_tpu_torch.ops.lie import so3_exp
    from voldor_tpu_torch.vo import em

    _, _, poses, flows, _, _, _ = scene
    dev, p = bi["d0"].device, bi["p"]
    fl = torch.as_tensor(flows[:n], device=dev)
    Rs = so3_exp(torch.as_tensor(poses[:n, :3], device=dev))
    ts = torch.as_tensor(poses[:n, 3:6], device=dev)
    rig = em.update_rigidness(bi["d0"], fl, Rs, ts, active_n, p).contiguous()
    track, tinb = em.precompute_obs_tracks(fl, active_n, p)
    ps = None
    if D:
        eye = torch.eye(3, device=dev)[None]
        ps = em.precompute_prior_samples(
            bi["d0"], torch.cat([bi["priors"], bi["d0"][None] * 0.97])[:D],
            torch.full((D, H, W), 0.9, device=dev), torch.cat([bi["confs"], bi["confs"][:1]])[:D],
            torch.cat([bi["dp_Rs"], eye])[:D], torch.cat([bi["dp_ts"], torch.zeros_like(bi["dp_ts"][:1])])[:D],
            p)
    return (track, tinb, rig, Rs, ts, active_n, p), ps


# (N, active_n, D, K) beside the bench window's: one frame, eight frames,
# four priors, a window cut short
COST_WIDE_CASES = ((1, 1, 4, 16), (8, 8, 4, 16), (8, 6, 0, 10), (8, 8, 4, 1), (8, 3, 2, 4))

FB_ODD_SHAPES = [(2, 1, W), (2, H, 1), (3, 37, W), (3, H, 61), (2, 37, 61), (1, 1, 1)]


def phase_fb(np, torch, bi):
    """fb_smooth kernel against its plain version on the bench's rigidness,
    and at shapes whose lines are shorter than a chunk or not a multiple of
    it; beside its chunked arithmetic in plain torch."""
    from voldor_tpu_torch.ops import fb_smooth as fb

    rig, _, _, _ = planes_at(bi, WINDOW, 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    cases = [(f"M={m} {H}x{W}", rig[:m].contiguous()) for m in (5, 3, 2, 1)]
    cases += [(f"{m}x{h}x{w}", torch.rand((m, h, w), generator=gen, device="cuda"))
              for m, h, w in FB_ODD_SHAPES]
    max_err = max_chunk = 0.0
    for name, x in cases:
        got = fb.fb_smooth(x, FB_EMM, FB_NCP)
        ref = fb.fb_smooth_reference(x, FB_EMM, FB_NCP)
        chunked = fb.fb_smooth_chunked_reference(x, FB_EMM, FB_NCP)
        torch.cuda.synchronize()
        err = float(torch.abs(got - ref).max())
        err_c = float(torch.abs(got - chunked).max())
        max_err, max_chunk = max(max_err, err), max(max_chunk, err_c)
        log(f"[fb_smooth] {name}: max_abs_err against fb_smooth_reference {err:.3e}; against "
            f"fb_smooth_chunked_reference {err_c:.3e} (bitwise equal {bool(torch.equal(got, chunked))})")
        if not err <= ATOL:
            raise AssertionError(f"fb_smooth kernel disagrees with its plain version ({name})")
    return max_err, max_chunk


def score_case(torch, what, cands, planes, ps):
    """One score-mode launch against the plain composition: the +inf
    pattern identical, finite values within RTOL / ATOL. Returns the
    largest absolute error."""
    from voldor_tpu_torch.ops import cost as cost_mod

    got = cost_mod.cost_map_score(cands, *planes, prior_samples=ps)
    again = cost_mod.cost_map_score(cands, *planes, prior_samples=ps)
    ref = cost_mod.normalize_cost(*cost_mod.cost_map_tracked_reference(cands, *planes, prior_samples=ps))
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"two launches differ ({what})")
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"+inf pattern differs ({what})")
    g, r = got[fin], ref[fin]
    bad = (torch.abs(g - r) > ATOL + RTOL * torch.abs(r)).sum().item()
    err = float(torch.abs(g - r).max()) if g.numel() else 0.0
    log(f"[score] {what}: finite {int(fin.sum())}/{fin.numel()} max_abs_err {err:.3e} out-of-tol {bad}")
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version ({what})")
    return err


def phase_score(np, torch, bi, scene):
    """Cost kernel in score mode against the plain composition."""
    from voldor_tpu_torch.ops import cost as cost_mod

    p, Rs, ts, cands_all = bi["p"], bi["Rs"], bi["ts"], bi["cands_all"]
    max_err = 0.0
    for active_n in (5, 3):
        for D in (0, 1, 2, 3):
            rig, track, tinb, ps = planes_at(bi, active_n, D, stereo=D == 3)
            for k in (1, 4, 10, 16):
                err = score_case(torch, f"K={k} D={D} active_n={active_n}", cost_cands(bi, k),
                                 (track, tinb, rig, Rs, ts, active_n, p), ps)
                max_err = max(max_err, err)
    for n, active_n, D, k in COST_WIDE_CASES:
        planes, ps = wide_planes(scene, bi, n, D, active_n)
        err = score_case(torch, f"K={k} N={n} D={D} active_n={active_n}", cost_cands(bi, k), planes, ps)
        max_err = max(max_err, err)
    # the demo's default abs_resize_factor (--resize 0.5): the rigidness,
    # tracks, prior samples and costs all at 0.5
    p05 = p._replace(abs_resize_factor=0.5)
    rig, track, tinb, ps = planes_at(bi, WINDOW, 2, p=p05)
    args = (cands_all, track, tinb, rig, Rs, ts, WINDOW, p05)
    got = cost_mod.cost_map_score(*args, prior_samples=ps)
    ref = cost_mod.normalize_cost(*cost_mod.cost_map_tracked_reference(*args, prior_samples=ps))
    rig1, track1, tinb1, ps1 = planes_at(bi, WINDOW, 2)
    at1 = cost_mod.cost_map_score(cands_all, track1, tinb1, rig1, Rs, ts, WINDOW, p, prior_samples=ps1)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    same_inf = torch.equal(fin, torch.isfinite(got))
    g, r = got[fin], ref[fin]
    bad = int((torch.abs(g - r) > ATOL + RTOL * torch.abs(r)).sum())
    err = float(torch.abs(g - r).max()) if g.numel() else 0.0
    both = fin & torch.isfinite(at1)
    moved = float(torch.abs(ref[both] - at1[both]).max())
    log(f"[score] abs_resize_factor 0.5, K=10 D=2 active_n={WINDOW}: finite {int(fin.sum())}/"
        f"{fin.numel()} max_abs_err {err:.3e} out-of-tol {bad}, +inf pattern identical {same_inf}; "
        f"the costs move by up to {moved:.3e} from abs_resize_factor 1")
    if bad or not same_inf or not moved > 0:
        raise AssertionError("the cost kernel at abs_resize_factor 0.5 disagrees with its plain version")
    return max(max_err, err)


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


def phase_accept(np, torch, bi, scene):
    """Cost kernel in accept mode against the plain composition: the depth
    round's three batches at N=5, D=2, and a masked K=16 batch at N=8,
    D=4."""
    from voldor_tpu_torch.ops import cost as cost_mod

    p, Rs, ts = bi["p"], bi["Rs"], bi["ts"]
    rig, track, tinb, ps = planes_at(bi, WINDOW, 2)
    planes = (track, tinb, rig, Rs, ts, WINDOW, p)
    jit = 1.0 + 0.1 * (torch.rand((H, W), generator=bi["gen"], device="cuda") - 0.5)
    depth = (bi["d0"] * jit).contiguous()
    batches = [(name, cands, masks, planes, ps) for name, cands, masks in accept_batches(torch, bi, depth)]
    planes8, ps8 = wide_planes(scene, bi, 8, 4, 8)
    c16 = cost_cands(bi, 16)
    m16 = torch.rand(c16.shape, generator=bi["gen"], device="cuda") < 0.7
    batches.append(("wide N=8 D=4 masked", c16, m16, planes8, ps8))
    worst = 1.0
    for name, cands, masks, planes, ps in batches:
        cost = cost_mod.normalize_cost(*cost_mod.cost_map_tracked_reference(
            depth[None], *planes, prior_samples=ps))[0]
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


# --------------------------------------------------------------------------
# the chain trace: a depth round's rigidness refresh and anchored tracks
# --------------------------------------------------------------------------

CHAIN_RIG_ATOL = 2e-6  # the kernel's rigidness against the plain version
CHAIN_CASES = ("bench", "jitter", "short", "behind", "edges", "nan")


def chain_case(torch, bi, name):
    """(depth, flows, Rs, ts, active_n) of one case at the bench window's
    size: its frame-0 depth, the depth jittered by +-15% (rigidness well
    below 1), the window cut short at 3 frames, points behind the camera
    and on its plane, a pose towards the scene (tracks leave at every
    edge), depths of 1e38 (NaN positions from frame 1 on), +inf and NaN."""
    depth, ts, active_n = bi["d0"].clone(), bi["ts"].clone(), WINDOW
    if name == "jitter":
        depth = bi["cands_all"][1].clone()
    elif name == "short":
        active_n = 3
    elif name == "behind":
        depth[20:60, 100:300] *= -1.0
        depth[90:94, :] = 0.0
    elif name == "edges":
        ts[:, 2] = -3.0
    elif name == "nan":
        depth[10:20, 50:400] = 1e38  # the projection overflows: NaN positions
        depth[30:40, 50:400] = torch.inf
        depth[150, 20:90] = torch.nan
    return depth.contiguous(), bi["fl"].contiguous(), bi["Rs"], ts, active_n


def same_bits(torch, a, b):
    """Bitwise equal as floats, NaN where NaN."""
    return bool(torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)))


def phase_chain_trace(np, torch, bi):
    """The chain trace kernel against its plain version on the card, with
    and without the track planes, on CHAIN_CASES: tracks and in-bounds
    bitwise equal, rigidness NaN where NaN and within CHAIN_RIG_ATOL, the
    rigidness-only launch bitwise equal to the full one, two launches
    bitwise equal. Returns (worst rigidness difference, share of rigidness
    entries bitwise equal)."""
    from voldor_tpu_torch.ops import chain_trace as ct

    worst, same, total = 0.0, 0, 0
    for name in CHAIN_CASES:
        depth, fl, Rs, ts, active_n = chain_case(torch, bi, name)
        p = bi["p"]
        rig, inb, track = ct.chain_trace(depth, fl, Rs, ts, active_n, p)
        rig2, inb2, none = ct.chain_trace(depth, fl, Rs, ts, active_n, p, tracks=False)
        again = ct.chain_trace(depth, fl, Rs, ts, active_n, p)
        prig, pinb, ptrack = ct.chain_trace_reference(depth, fl, Rs, ts, active_n, p)
        tracks_same = [same_bits(torch, a, b) for a, b in zip(track, ptrack)]
        nan_same = bool(torch.equal(rig.isnan(), prig.isnan()))
        d = (torch.nan_to_num(rig, nan=0.0) - torch.nan_to_num(prig, nan=0.0)).abs()
        err = float(d.max())
        n_same = int(((rig == prig) | (rig.isnan() & prig.isnan())).sum())
        worst, same, total = max(worst, err), same + n_same, total + rig.numel()
        repeat = (same_bits(torch, rig2, rig) and torch.equal(inb2, inb) and none is None
                  and same_bits(torch, again[0], rig)
                  and all(same_bits(torch, a, b) for a, b in zip(again[2], track)))
        log(f"[chain] {name} (active_n {active_n}): in-bounds equal {torch.equal(inb, pinb)} "
            f"({int(pinb.sum())} of {pinb.numel()}); tracks px, py, obx, oby bitwise {tracks_same}; "
            f"rigidness max abs diff {err:.3e}, bitwise on {n_same} of {rig.numel()}, NaN pattern "
            f"equal {nan_same} ({int(prig.isnan().sum())} NaN); without tracks and repeated bitwise "
            f"{repeat}")
        if not (torch.equal(inb, pinb) and all(tracks_same) and nan_same and repeat
                and err <= CHAIN_RIG_ATOL):
            raise AssertionError(f"chain trace kernel disagrees with the plain version ({name})")
    log(f"[chain] rigidness bitwise equal on {same} of {total} entries ({100.0 * same / total:.4f}%), "
        f"worst {worst:.3e} (limit {CHAIN_RIG_ATOL:g})")
    return worst, same / total


# The chain trace's pieces (ops/chain_trace.py's plain version), counted
# from the formula in its operation order:
CT_PIECES = {
    # per pixel: the back-projection (2 sub, 2 div, 2 mul)
    "px": least_ops(4, div=2),
    # per pixel and traced frame: the point moved on (9 mul, 9 add), safe nz
    # (2), projection (6, 2 div), the in-bounds tests (9), the bilinear
    # sample (clamps 6, floors 2, fractions 2, NaN indices 2, tap indices 6,
    # weights 2, lerps 18), the carry (2)
    "frame": least_ops(67, div=2),
    # per in-bounds term: rigid flow (2), |observed flow| (3, sqrt, div),
    # residual (2), its norm (3, sqrt, div), clamp (3), shape (2), scale (2,
    # exp), lam (1), two Fisk densities (9, 4 div, pow each), ratio (1, div)
    "rig": least_ops(37, div=11, sqrt=2, exp=1, pow=2),
}
CHAIN_THREADS = (128, 256)


def chain_trace_times(np, torch, bi):
    """The chain trace kernel device-only at the bench window (N = 5, all
    frames traced), with and without the track planes, at 128 and 256
    threads a block (bound C calls, CUDA events over N_LAUNCH launches, two
    rounds in opposite orders), beside its bound (bytes over 3.35 TB/s;
    the least operations of CT_PIECES on this run's data over the peak
    rates), its registers and occupancy, and update_rigidness_and_tracks
    through the wrapper beside the plain composition it replaced: host
    milliseconds a call (N_LAUNCH calls dispatched, no synchronisation)
    and event milliseconds a call."""
    from voldor_tpu_torch.ops import _build
    from voldor_tpu_torch.ops import chain_trace as ct
    from voldor_tpu_torch.vo import em

    depth, fl, Rs, ts, active_n = chain_case(torch, bi, "bench")
    p = bi["p"]
    px = H * W
    info_fn = _build.function("chain_trace_info", [ctypes.c_int, ctypes.c_int,
                                                   ctypes.POINTER(ctypes.c_int)])
    bound = {tr: ct._bind(depth, fl, Rs, ts, active_n, p, tr) for tr in (True, False)}
    runs = {(tr, n): [] for tr in (True, False) for n in CHAIN_THREADS}
    for order in (list(runs), list(runs)[::-1]):
        for tr, n in order:
            fn, args, _out, _poses = bound[tr]
            args = args[:-2] + (n, args[-1])
            runs[tr, n].append(device_ms(torch, lambda: checked(fn(*args), "chain trace")))
    occ = {}
    for tr in (True, False):
        for n in CHAIN_THREADS:
            info = (ctypes.c_int * 3)()
            checked(info_fn(int(tr), n, info), "chain_trace_info")
            occ[f"{'tracks' if tr else 'rigidness'}_{n}"] = dict(
                registers=info[0], spill_bytes=info[1], warps_per_sm=info[2] * n // 32)
    rig, inb, _ = ct.chain_trace(depth, fl, Rs, ts, active_n, p)
    counts = dict(px=px, frame=active_n * px, rig=int(inb.sum()))
    fp32_ms, sfu_ms = ops_ms(counts, CT_PIECES)
    by_bytes = {tr: px * (4 + 8 * active_n + WINDOW * (5 + 16 * tr)) / HBM_BYTES_PER_S * 1e3
                for tr in (True, False)}
    bounds = {tr: max(by_bytes[tr], fp32_ms, sfu_ms) for tr in (True, False)}
    ms = {tr: min(min(runs[tr, n]) for n in CHAIN_THREADS) for tr in (True, False)}
    best_threads = min(CHAIN_THREADS, key=lambda n: min(runs[True, n]))

    def plain():
        return ct.chain_trace_reference(depth, fl, Rs, ts, active_n, p)

    def wrapper():
        return em.update_rigidness_and_tracks(depth, fl, Rs, ts, active_n, p)

    def host_ms(fn, n=N_LAUNCH):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        return dt

    calls = {}
    for name, fn in (("plain", plain), ("wrapper", wrapper), ("wrapper", wrapper), ("plain", plain)):
        calls.setdefault(name, []).append((host_ms(fn), event_ms(torch, fn, 20)))
    rec = dict(ms=ms[True], ms_rigidness_only=ms[False],
               ms_by_threads={f"{'tracks' if tr else 'rigidness'}_{n}": min(v)
                              for (tr, n), v in runs.items()},
               threads=ct.THREADS, fastest_threads=best_threads,
               bound_ms=bounds[True], bound_ms_rigidness_only=bounds[False],
               bound_by="bytes" if by_bytes[True] >= max(fp32_ms, sfu_ms) else "operations",
               bytes_us=by_bytes[True] * 1e3, fp32_us=fp32_ms * 1e3, sfu_us=sfu_ms * 1e3,
               evaluated=counts, occupancy=occ,
               plain_ms=min(e for _, e in calls["plain"]),
               host_ms_per_call={k: [h for h, _ in v] for k, v in calls.items()},
               event_ms_per_call={k: [e for _, e in v] for k, v in calls.items()})
    log(f"[times] chain trace N={WINDOW} {H}x{W}: device ms per launch (min of two rounds of "
        f"{N_LAUNCH}) {json.dumps(rec['ms_by_threads'])} (the wrapper launches {ct.THREADS} "
        f"threads a block; fastest with tracks: {best_threads}); occupancy {json.dumps(occ)}; "
        f"evaluated {counts}; least operations FP32 {fp32_ms * 1e3:.2f} us, special-function "
        f"{sfu_ms * 1e3:.2f} us; bytes {by_bytes[True] * 1e3:.2f} us with tracks, "
        f"{by_bytes[False] * 1e3:.2f} us without; bound {bounds[True] * 1e3:.2f} / "
        f"{bounds[False] * 1e3:.2f} us")
    log(f"[times] update_rigidness_and_tracks a call, order plain, wrapper, wrapper, plain: host ms "
        f"(dispatch of {N_LAUNCH} calls, no sync) {json.dumps(rec['host_ms_per_call'])}; event ms "
        f"(median of 20) {json.dumps(rec['event_ms_per_call'])}")
    return rec


# --------------------------------------------------------------------------
# the pose sweep's collect: traced and obs correspondences
# --------------------------------------------------------------------------

COLLECT_VARIANTS = ("shipped", "edges", "rig_sum", "no_far", "anchored")


def collect_inputs(torch, bi):
    """The collect's operands at the bench window: the frame-0 depth with the
    depths the collect must refuse (NaN, +inf, negative, nearer than the
    least and farther than the greatest sample depth), the rigidness and
    the anchored tracks of the chain trace at the jittered depth (rigidness
    well below 1 in places), and the shipped collect settings of the bench
    config."""
    from voldor_tpu_torch.config import VoldorConfig
    from voldor_tpu_torch.ops import chain_trace as ct
    from voldor_tpu_torch.vo import engine, pose_step

    depth = bi["d0"].clone()
    depth[10:20, 50:400] = torch.nan
    depth[30:33, 50:400] = torch.inf
    depth[60:70, 100:300] = -2.0
    depth[90:92, :] = 0.01
    depth[120:125, 300:500] = 2000.0
    rig, inb, track = ct.chain_trace(bi["cands_all"][1].contiguous(), bi["fl"], bi["Rs"],
                                     bi["ts"], WINDOW, bi["p"])
    cfg = VoldorConfig(fx=FX, fy=FY, cx=W / 2, cy=H / 2, basefocal=BASEFOCAL)
    cfg.read_config(CONFIG)
    return dict(depth=depth.contiguous(), rig=rig, anchored=(track, inb),
                ckw=pose_step._collect_kw(engine.pose_hp(cfg)))


def collect_cases(torch, bi, ci, mode, variant, M, stride):
    """(ts, ckw, [(active, inputs)]) of one case: every target (traced) or
    every active_n (obs, the in-bounds flags false over a patch from frame
    2 on)."""
    from voldor_tpu_torch.vo import em

    ts = bi["ts"].clone()
    ckw = dict(ci["ckw"], max_trace_on_flow=M, sample_stride=stride)
    if variant == "edges":
        ts[:, 2] = -3.0
        ts[:, 0] = 2.5
    elif variant == "rig_sum":
        ckw["rigidness_sum_threshold"] = WINDOW + 1.5
    elif variant == "no_far":
        ckw["sample_max_depth"] = 0.0
    if mode == "traced":
        return ts, ckw, [(a, dict(flows=bi["fl"])) for a in range(WINDOW)]
    cases = []
    for n in range(WINDOW + 1):
        if variant == "anchored":
            track, tinb = ci["anchored"]
        else:
            track, tinb = em.precompute_obs_tracks(bi["fl"], n, bi["p"])
        tinb = tinb.clone()
        tinb[2:, 100:140, 200:400] = False
        cases.append((n, dict(obs_track=track, obs_tinb=tinb)))
    return ts, ckw, cases


def plain_collect(bi, ci, ts, active, ckw, flows=None, obs_track=None, obs_tinb=None):
    from voldor_tpu_torch.vo import pose_step

    args = (ci["rig"], bi["Rs"], ts, active, bi["p"])
    if obs_track is None:
        return pose_step.collect_p3p_instances(ci["depth"], flows, *args, **ckw)
    return pose_step.collect_p3p_instances_obs(ci["depth"], obs_track, obs_tinb, *args, **ckw)


def phase_pose_collect(np, torch, bi, ci):
    """The pose collect kernel against the plain collects on the card, both
    modes, over COLLECT_VARIANTS, strides 1 and 2 and max_trace_on_flow 0,
    1 and 3: p2, p3 and valid bitwise equal, and a repeat launch bitwise
    equal. Returns the number of launches compared."""
    from voldor_tpu_torch.ops import pose_collect as pc

    n_cases, n_valid = 0, {"traced": 0, "obs": 0}
    for mode in ("traced", "obs"):
        for variant in COLLECT_VARIANTS:
            if mode == "traced" and variant == "anchored":
                continue
            for stride in (1, 2):
                for M in (0, 1, 3):
                    ts, ckw, cases = collect_cases(torch, bi, ci, mode, variant, M, stride)
                    for active, extra in cases:
                        before = pc.pose_collect_launches
                        out = pc.pose_collect(ci["depth"], ci["rig"], bi["Rs"], ts, active, bi["p"],
                                              **extra, **ckw)
                        again = pc.pose_collect(ci["depth"], ci["rig"], bi["Rs"], ts, active,
                                                bi["p"], **extra, **ckw)
                        ref = plain_collect(bi, ci, ts, active, ckw, **extra)
                        same = (torch.equal(out[2], ref[2]) and same_bits(torch, out[0], ref[0])
                                and same_bits(torch, out[1], ref[1]))
                        repeat = all(same_bits(torch, a.float(), b.float())
                                     for a, b in zip(again, out))
                        if not (same and repeat and pc.pose_collect_launches == before + 2):
                            raise AssertionError(
                                f"pose collect kernel disagrees with the plain version ({mode}, "
                                f"{variant}, stride {stride}, M {M}, active {active}): bitwise "
                                f"{same}, repeat {repeat}")
                        n_cases += 1
                        n_valid[mode] += int(ref[2].sum())
    log(f"[collect] both modes bitwise equal to the plain collects on {n_cases} launches "
        f"({', '.join(COLLECT_VARIANTS)}; strides 1, 2; max_trace_on_flow 0, 1, 3; every target "
        f"and active_n), a repeat bitwise equal; valid correspondences over the cases {n_valid}")
    return n_cases


def collect_frames_read(torch, rig, a, lo, thresh):
    """Per pixel of the traced collect at target a: (rigidness planes the
    product reads, flow frames the trace samples), as the kernel walks."""
    prod = torch.ones_like(rig[0])
    alive = torch.ones_like(rig[0], dtype=torch.bool)
    n_rig = torch.zeros_like(rig[0], dtype=torch.int32)
    n_trace = torch.zeros_like(n_rig)
    for f in range(a, lo - 1, -1):
        n_rig = n_rig + alive.to(torch.int32)
        pn = prod * rig[f]
        alive = alive & (pn > thresh)
        prod = torch.where(alive, pn, prod)
        n_trace = n_trace + alive.to(torch.int32)
    return int(n_rig.sum()), int(n_trace.sum())


def pose_collect_times(np, torch, bi, ci):
    """The pose collect kernel device-only at the sweeps' shapes (stride 1,
    the shipped max_trace_on_flow): obs at active_n = N (the Jacobi sweep)
    and traced at the last target (the sequential sweep's longest walk),
    bound C calls, CUDA events over N_LAUNCH launches, two rounds in
    opposite orders; beside its bound (the bytes these inputs need over
    3.35 TB/s: obs every input plane once and the outputs; traced the
    depth, the rigidness planes the product reads, one float2 a traced
    frame and the outputs), its registers and occupancy, and a collect
    through the wrapper beside the plain collect (host ms of N_LAUNCH calls
    dispatched without synchronising, and event ms a call)."""
    from voldor_tpu_torch.ops import _build
    from voldor_tpu_torch.ops import pose_collect as pc
    from voldor_tpu_torch.vo import em

    px = H * W
    ckw = dict(ci["ckw"])
    M = int(ckw["max_trace_on_flow"])
    track, tinb = em.precompute_obs_tracks(bi["fl"], WINDOW, bi["p"])
    a = WINDOW - 1
    shapes = {
        "obs": (WINDOW, dict(obs_track=track, obs_tinb=tinb)),
        "traced": (a, dict(flows=bi["fl"])),
    }
    bound = {m: pc._bind(ci["depth"], ci["rig"], bi["Rs"], bi["ts"], act, bi["p"],
                         ex.get("flows"), ex.get("obs_track"), ex.get("obs_tinb"), **ckw)
             for m, (act, ex) in shapes.items()}
    runs = {m: [] for m in shapes}
    for order in (list(shapes), list(shapes)[::-1]):
        for m in order:
            fn, args, _out, _poses = bound[m]
            runs[m].append(device_ms(torch, lambda: checked(fn(*args), "pose collect")))
    info_fn = _build.function("pose_collect_info", [ctypes.c_int, ctypes.c_int,
                                                    ctypes.POINTER(ctypes.c_int)])
    occ = {}
    for m in shapes:
        info = (ctypes.c_int * 3)()
        checked(info_fn(int(m == "obs"), pc.THREADS, info), "pose_collect_info")
        occ[m] = dict(registers=info[0], spill_bytes=info[1],
                      warps_per_sm=info[2] * pc.THREADS // 32)
    lo = max(0, a - M + 1) if M > 0 else 0
    n_rig, n_flow = collect_frames_read(torch, ci["rig"], a, lo, ckw["rigidness_threshold"])
    out_b = 8 + 12 + 1
    by_bytes = {
        "obs": px * (4 + WINDOW * (4 + 16 + 1) + WINDOW * out_b),
        "traced": px * (4 + out_b) + 4 * n_rig + 8 * n_flow,
    }
    bound_ms = {m: b / HBM_BYTES_PER_S * 1e3 for m, b in by_bytes.items()}

    def wrapper(m):
        act, ex = shapes[m]
        return lambda: pc.pose_collect(ci["depth"], ci["rig"], bi["Rs"], bi["ts"], act, bi["p"],
                                       **ex, **ckw)

    def plain(m):
        act, ex = shapes[m]
        return lambda: plain_collect(bi, ci, bi["ts"], act, ckw, **ex)

    def host_ms(fn, n=N_LAUNCH):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        return dt

    calls = {}
    for m in shapes:
        for name, make in (("plain", plain), ("kernel", wrapper), ("kernel", wrapper),
                           ("plain", plain)):
            fn = make(m)
            calls.setdefault(f"{m}_{name}", []).append((host_ms(fn), event_ms(torch, fn, 20)))
    ms = {m: min(v) for m, v in runs.items()}
    rec = dict(ms=ms["obs"], ms_traced=ms["traced"], threads=pc.THREADS,
               bound_ms=bound_ms["obs"], bound_ms_traced=bound_ms["traced"], bound_by="bytes",
               bytes_by_mode=by_bytes, roofline_pct={m: 100.0 * bound_ms[m] / ms[m] for m in ms},
               occupancy=occ, traced_reads=dict(rig_planes=n_rig, flow_frames=n_flow),
               plain_ms=min(e for _, e in calls["obs_plain"]),
               plain_ms_traced=min(e for _, e in calls["traced_plain"]),
               host_ms_per_call={k: [h for h, _ in v] for k, v in calls.items()},
               event_ms_per_call={k: [e for _, e in v] for k, v in calls.items()})
    log(f"[times] pose collect {H}x{W}, N={WINDOW}: device ms per launch (min of two rounds of "
        f"{N_LAUNCH}) obs {ms['obs']:.5f} (active_n {WINDOW}), traced {ms['traced']:.5f} (target "
        f"{a}, max_trace_on_flow {M}); bound by bytes obs {bound_ms['obs'] * 1e3:.2f} us "
        f"({by_bytes['obs'] / 1e6:.2f} MB), traced {bound_ms['traced'] * 1e3:.2f} us "
        f"({by_bytes['traced'] / 1e6:.2f} MB; rigidness planes read {n_rig}, flow frames "
        f"{n_flow}); "
        f"occupancy {json.dumps(occ)}")
    log(f"[times] a collect, order plain, kernel, kernel, plain: host ms (dispatch of {N_LAUNCH} "
        f"calls, no sync) {json.dumps(rec['host_ms_per_call'])}; event ms (median of 20) "
        f"{json.dumps(rec['event_ms_per_call'])}")
    return rec


# --------------------------------------------------------------------------
# the pose sweep's kernels: P4P, meanshift, the robust-Gaussian refit
# --------------------------------------------------------------------------

N_POSES = 8192  # the shipped n_poses_to_sample
# P4P per hypothesis, its plain formula (ops/p3p.py:_p4p_batch) counted at
# its least (an FMA of a 3x3 product one FP32 instruction): 3 bearings (18,
# 15 div, 3 sqrt), the bearing products and distances (51), the cubic's
# coefficients (51, div), its start (35, 5 div, 3 sqrt) and 24 Newton steps
# (13 and a div each), the eigenvectors (~90, 7 div, 4 sqrt), both
# lambda_candidates (170, 12 div, 6 sqrt), X's inverse (34, 9 div), per
# depth triple 5 Gauss-Newton steps (~120 and a div each) and its pose and
# reprojection (~100, 2 div), so3_log (~100, 25 div, 6 sqrt)
P4P_PIECE = least_ops(3700, div=126, sqrt=22)
# meanshift per row and weighting (init trial or step) at D: the weight
# (D sub, D mul, D - 1 add, neg, div, exp, the valid product) and its sums
# (the weight, D products added: D + 1 FMA-counted)
def ms_piece(D):
    return least_ops(3 * D + 1 + D + 1, div=1, exp=1)


# the robust-Gaussian refit per row: an E-step (6 sub, the Mahalanobis
# form's 36 + 6 FMA-counted products, the compare and select, 7 sums) and
# a committed M-step (6 sub, 6 weights, 36 FMA-counted products)
RG_ESTEP = least_ops(58)
RG_MSTEP = least_ops(48)
POSE_TOL = dict(p4p_ok=0.999, p4p_within=0.99, p4p_atol=1e-4, p4p_max=1e-3,
                rg_mean=(1e-5, 1e-4), rg_cov=(1e-4, 1e-4), rg_density=1e-6)


def capture_pose_inputs(np, torch, scene):
    """The pose sweep's inputs at the main path's shapes: the first window
    of the bench scene (613x185, CONFIG) through voldor_dispatch on the
    card, recording the first _solve_and_fuse call of each batch size (B =
    1: the sequential sweep of EM iteration 1; B = 5: the Jacobi sweep),
    and the 4-D pool of the KITTI ground fit of the window's depth."""
    import voldor_tpu_torch
    from voldor_tpu_torch.vo import kitti_ground, pose_step

    flows = scene[3]
    seen = {}
    orig = pose_step._solve_and_fuse
    sig = inspect.signature(orig)

    def recording(*a, **k):
        args = sig.bind(*a, **k).arguments
        B = args["valid"].shape[0]
        if B not in seen:
            seen[B] = {n: (v.clone() if isinstance(v, torch.Tensor) else v) for n, v in args.items()
                       if n != "gen"}
        return orig(*a, **k)

    pose_step._solve_and_fuse = recording
    try:
        win = voldor_tpu_torch.voldor_dispatch(flows[:WINDOW], FX, FY, W / 2, H / 2,
                                               basefocal=BASEFOCAL, config=CONFIG, device="cuda")
        win.collect()
    finally:
        pose_step._solve_and_fuse = orig
    if set(seen) != {1, WINDOW}:
        raise AssertionError(f"the window's fuse calls had batch sizes {sorted(seen)}")
    ground = {}
    orig_ms = kitti_ground.meanshift

    def ground_pool(*a, **k):
        ground["args"] = a
        return orig_ms(*a, **k)

    kitti_ground.meanshift = ground_pool
    try:
        K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)
        kitti_ground.estimate_kitti_ground(win.engine.depth, K, ms_kernel_var=0.01)
    finally:
        kitti_ground.meanshift = orig_ms
    return dict(fuse=seen, ground=ground["args"])


def pose_pipeline(torch, cap, B, seed):
    """_solve_and_fuse's operands for the captured call of batch size B,
    drawn from a generator seeded with `seed`: (P4P arguments, the rvec
    scale, the meanshift init and trials, the RG scale and covar0, hp)."""
    from voldor_tpu_torch.ops.meanshift import draw_meanshift_trials
    from voldor_tpu_torch.ops.p3p import draw_p4p_indices

    c = cap["fuse"][B]
    hp, p = c["hp"], c["p"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    idx = draw_p4p_indices(gen, c["valid"], hp["n_poses_to_sample"])
    p4p_args = (c["p2s"], c["p3s"], c["valid"], idx, p.fx, p.fy, p.cx, p.cy)
    rs = hp["meanshift_rvec_scale"]
    init = torch.cat([c["ms_init"][:, :3] * rs, c["ms_init"][:, 3:6]], dim=-1)
    s = hp["rg_pose_scaling"]
    covar0 = (torch.eye(6, device="cuda") * (hp["meanshift_kernel_var"] * s * s)).expand(B, 6, 6)
    return dict(p4p=p4p_args, rs=rs, init=init, gen=gen, s=s, covar0=covar0, hp=hp)


def same_nan(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def phase_pose_kernels(np, torch, cap):
    """Phase 5b: the pose sweep's three kernels against their plain
    versions on the card at the main path's shapes (module docstring)."""
    from voldor_tpu_torch.ops import meanshift as ms
    from voldor_tpu_torch.ops import p3p
    from voldor_tpu_torch.ops import robust_gaussian as rg

    out = dict(p4p_max_err=0.0, ms_max_err=0.0, rg_max_err=0.0, ms_ground_err=0.0)
    for B in (1, WINDOW):
        pp = pose_pipeline(torch, cap, B, 100 + B)
        hp = pp["hp"]
        M = pp["p4p"][0].shape[1]
        # P4P, on the same draws
        rv, tv, ok = p3p.solve_batch_p4p(*pp["p4p"])
        rv2, tv2, ok2 = p3p.solve_batch_p4p(*pp["p4p"])
        prv, ptv, pok = p3p.solve_batch_p4p_reference(*pp["p4p"])
        pool, pool_valid = p3p.solve_batch_p4p_pool(*pp["p4p"], pp["rs"])
        torch.cuda.synchronize()
        ok_same = float((ok == pok).double().mean())
        both = ok & pok
        err = torch.maximum((rv - prv).abs().amax(-1), (tv - ptv).abs().amax(-1))[both]
        within = float((err <= POSE_TOL["p4p_atol"]).double().mean())
        worst = float(err.max()) if err.numel() else 0.0
        bitwise = float((err == 0).double().mean()) if err.numel() else 1.0
        repeat = same_nan(rv, rv2) and same_nan(tv, tv2) and torch.equal(ok, ok2)
        pool_same = same_nan(pool, torch.cat([rv * pp["rs"], tv], dim=-1)) and torch.equal(
            pool_valid, ok.to(torch.float32))
        out["p4p_max_err"] = max(out["p4p_max_err"], worst)
        log(f"[pose] P4P B={B} M={M} S={rv.shape[1]}: ok flags equal on {ok_same:.6f} "
            f"({float(ok.double().mean()):.4f} ok); where both ok, within {POSE_TOL['p4p_atol']:g} on "
            f"{within:.6f}, bitwise on {bitwise:.6f}, worst {worst:.3e}; two launches bitwise "
            f"{repeat}; the pool output equal to [rvec * {pp['rs']:g}, t] {pool_same}")
        if not (ok_same >= POSE_TOL["p4p_ok"] and within >= POSE_TOL["p4p_within"]
                and worst <= POSE_TOL["p4p_max"] and repeat and pool_same):
            raise AssertionError(f"the P4P kernel disagrees with its plain version (B={B})")
        # meanshift, on the kernel's pool, with the external start off and on
        trials = ms.draw_meanshift_trials(pp["gen"], pool_valid, hp["meanshift_max_init_trials"])
        kw = dict(epsilon=hp["meanshift_epsilon"], max_iters=hp["meanshift_max_iters"],
                  good_init_confidence=hp["meanshift_good_init_confidence"])
        for ext in (False, True):
            use = torch.full((B,), ext, dtype=torch.bool, device="cuda")
            a = (pool, pool_valid, hp["meanshift_kernel_var"], pp["init"], use, trials)
            k, k2, pl = ms.meanshift(*a, **kw), ms.meanshift(*a, **kw), ms.meanshift_reference(*a, **kw)
            e = max(float((k.mean - pl.mean).abs().max()), float((k.confidence - pl.confidence).abs().max()))
            out["ms_max_err"] = max(out["ms_max_err"], e)
            good = (torch.equal(k.iters, pl.iters) and torch.equal(k.n_valid, pl.n_valid)
                    and bool(close(k.mean, pl.mean).all()) and bool(close(k.confidence, pl.confidence).all()))
            rep = torch.equal(k.mean, k2.mean) and torch.equal(k.iters, k2.iters)
            log(f"[pose] meanshift B={B} external start {ext}: iterations kernel {k.iters.tolist()} "
                f"plain {pl.iters.tolist()}; mean and confidence max abs err {e:.3e} (bitwise "
                f"{torch.equal(k.mean, pl.mean) and torch.equal(k.confidence, pl.confidence)}); two "
                f"launches bitwise {rep}")
            if not (good and rep):
                raise AssertionError(f"the meanshift kernel disagrees with its plain version (B={B})")
        # the robust-Gaussian refit, as _solve_and_fuse calls it
        m0 = ms.meanshift(pool, pool_valid, hp["meanshift_kernel_var"], pp["init"],
                          torch.zeros(B, dtype=torch.bool, device="cuda"), trials, **kw).mean
        s = pp["s"]
        a = (pool * s, pool_valid, m0 * s, pp["covar0"])
        rkw = dict(trunc_sigma=hp["rg_trunc_sigma"], covar_reg_lambda=hp["rg_covar_reg_lambda"],
                   epsilon=hp["rg_epsilon"], max_iters=hp["rg_max_iters"])
        k, k2, pl = rg.fit_robust_gaussian(*a, **rkw), rg.fit_robust_gaussian(*a, **rkw), \
            rg.fit_robust_gaussian_reference(*a, **rkw)
        (mr, ma), (cr, ca) = POSE_TOL["rg_mean"], POSE_TOL["rg_cov"]
        em = float((k.mean - pl.mean).abs().max())
        ec = float((k.covar - pl.covar).abs().max())
        ed = float(((k.density - pl.density).abs() / pl.density.abs().clamp_min(1e-30)).max())
        out["rg_max_err"] = max(out["rg_max_err"], em, ec)
        good = (torch.equal(k.iters, pl.iters) and torch.equal(k.reliable, pl.reliable)
                and bool(((k.mean - pl.mean).abs() <= ma + mr * pl.mean.abs()).all())
                and bool(((k.covar - pl.covar).abs() <= ca + cr * pl.covar.abs()).all())
                and ed <= POSE_TOL["rg_density"])
        rep = torch.equal(k.covar, k2.covar) and torch.equal(k.mean, k2.mean)
        log(f"[pose] robust Gaussian B={B}: iterations kernel {k.iters.tolist()} plain "
            f"{pl.iters.tolist()}, reliable {k.reliable.tolist()} / {pl.reliable.tolist()}; max abs "
            f"err mean {em:.3e}, covariance {ec:.3e}, density rel {ed:.3e} (bitwise "
            f"{torch.equal(k.mean, pl.mean) and torch.equal(k.covar, pl.covar)}); two launches "
            f"bitwise {rep}")
        if not (good and rep):
            raise AssertionError(f"the robust-Gaussian kernel disagrees with its plain version (B={B})")
    # the KITTI ground fit's 4-D pool, external start, one dummy trial
    ga = cap["ground"]
    k, pl = ms.meanshift(*ga), ms.meanshift_reference(*ga)
    e = max(float((k.mean - pl.mean).abs().max()), float((k.confidence - pl.confidence).abs().max()))
    out["ms_ground_err"] = e
    log(f"[pose] meanshift ground pool {tuple(ga[0].shape)}: iterations kernel {k.iters.tolist()} "
        f"plain {pl.iters.tolist()}, max abs err {e:.3e}")
    if not (torch.equal(k.iters, pl.iters) and bool(close(k.mean, pl.mean).all())
            and bool(close(k.confidence, pl.confidence).all())):
        raise AssertionError("the meanshift kernel disagrees with its plain version on the ground pool")
    return out


@contextlib.contextmanager
def plain_fuse():
    """The three plain versions patched into vo/pose_step.py's fuse."""
    from voldor_tpu_torch.ops import meanshift as ms
    from voldor_tpu_torch.ops import p3p
    from voldor_tpu_torch.ops import robust_gaussian as rg
    from voldor_tpu_torch.vo import pose_step

    saved = (pose_step.meanshift, pose_step.fit_robust_gaussian, p3p.solve_batch_p4p_pool)
    pose_step.meanshift = ms.meanshift_reference
    pose_step.fit_robust_gaussian = rg.fit_robust_gaussian_reference
    p3p.solve_batch_p4p_pool = p3p.solve_batch_p4p_pool_reference
    try:
        yield
    finally:
        pose_step.meanshift, pose_step.fit_robust_gaussian, p3p.solve_batch_p4p_pool = saved


def fuse_launches(torch, cap):
    """(kernel launches, syncs) of one _solve_and_fuse call with the RG
    refit, on the kernels and on the plain fuse, at B = 1 and B = 5 (the
    profile's own closing synchronize counted)."""
    from voldor_tpu_torch.vo import pose_step

    out = {}
    for B in (1, WINDOW):
        c = dict(cap["fuse"][B], rg_refine=True)

        def fuse():
            gen = torch.Generator(device="cuda")
            gen.manual_seed(7)
            pose_step._solve_and_fuse(c["p2s"], c["p3s"], c["valid"], c["ms_init"], c["successive"],
                                      c["rg_refine"], gen, c["p"], c["hp"])

        fuse()
        kern = profile_counts(torch, fuse)[:2]
        with plain_fuse():
            plain = profile_counts(torch, fuse)[:2]
        out[B] = dict(kernels=kern, plain=plain)
    log(f"[pose] one _solve_and_fuse call with the RG refit, (kernel launches, syncs): "
        f"{ {B: (r['kernels'], r['plain']) for B, r in out.items()} } (kernels, plain fuse)")
    return out


def phase_pose_ab(np, torch, scene):
    """The pose path A/B: the three windows of phase 7 with the kernels,
    then with the plain fuse (the three plain versions patched into
    vo/pose_step.py), from the same seeds. Returns its record."""
    from voldor_tpu_torch.utils.evaluation import ate_rmse

    gt = np.linalg.inv(scene[5][:N_WINDOWS * WINDOW + 1])
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    est_k, walls_k, iters_k, _ = run_sequence(np, torch, scene)
    with plain_fuse():
        est_p, walls_p, iters_p, _ = run_sequence(np, torch, scene)
    ate_k = ate_rmse(est_k.astype(np.float64), gt, with_scale=True)
    ate_p = ate_rmse(est_p.astype(np.float64), gt, with_scale=True)
    d_t = float(np.abs(est_k[:, :3, 3] - est_p[:, :3, 3]).max())
    d_r = float(np.abs(est_k[:, :3, :3] - est_p[:, :3, :3]).max())
    rec = dict(ate_kernels=ate_k, ate_plain=ate_p, max_translation_diff=d_t, max_rotation_entry_diff=d_r,
               walls_kernels=walls_k, walls_plain=walls_p, em_iters_kernels=iters_k, em_iters_plain=iters_p)
    log(f"[pose-ab] three windows, kernels vs the plain fuse from the same seeds: Sim3 ATE "
        f"{ate_k:.6f} / {ate_p:.6f} (gate {0.02 * extent:.6f}); camera positions differ by at most "
        f"{d_t:.3e}, rotation entries by {d_r:.3e}; EM iterations {iters_k} / {iters_p}; wall s "
        f"{[round(x, 4) for x in walls_k]} / {[round(x, 4) for x in walls_p]}")
    if not (ate_k < 0.02 * extent and ate_p < 0.02 * extent):
        raise AssertionError("the pose A/B: a trajectory fails the Sim3-ATE gate")
    return rec


def pose_probe_ns(torch):
    """Latency of one block sum of Q values (Q = 7, 8, 36) on one block of
    the pose kernels, from pose_reduce_probe_kernel: ns per sum."""
    from voldor_tpu_torch.ops import _build

    fn = _build.function("pose_reduce_probe_launch", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                      ctypes.c_void_p])
    out = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n = 20000
    ns = {}
    for q in (7, 8, 36):
        checked(fn(out.data_ptr(), 100, q, stream), "reduce probe")
        ms_ = event_ms(torch, lambda: checked(fn(out.data_ptr(), n, q, stream), "reduce probe"), 3)
        ns[q] = ms_ / n * 1e6
    return ns


def pose_times(np, torch, cap):
    """Phase 6's pose kernels: device-only times of the bound C calls at the
    Jacobi sweep's shape (B = 5) and the sequential sweep's (B = 1), the
    plain versions' times, the bounds and the chain floors."""
    from voldor_tpu_torch.ops import _build
    from voldor_tpu_torch.ops import meanshift as ms
    from voldor_tpu_torch.ops import p3p
    from voldor_tpu_torch.ops import robust_gaussian as rg
    from voldor_tpu_torch.ops.reduce import THREADS

    stream = torch.cuda.current_stream().cuda_stream
    probe = pose_probe_ns(torch)
    rec = {}
    for B in (WINDOW, 1):
        pp = pose_pipeline(torch, cap, B, 200 + B)
        hp = pp["hp"]
        p2s, p3s, valid, idx = (x.contiguous() for x in pp["p4p"][:4])
        M, S = valid.shape[1], idx.shape[1]
        # P4P: the wrapper's operands, then the C call alone
        order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
        n_valid = valid.sum(dim=-1, dtype=torch.int32)
        pool = torch.empty((B, S, 6), device="cuda")
        pool_valid = torch.empty((B, S), device="cuda")
        pfn = _build.function("p4p_launch", p3p._ARGTYPES)
        pargs = (p2s.data_ptr(), p3s.data_ptr(), order.data_ptr(), idx.data_ptr(), n_valid.data_ptr(),
                 B, M, S, *pp["p4p"][4:], pp["rs"], 0, 0, 0, pool.data_ptr(), pool_valid.data_ptr(),
                 stream)
        p4p_ms = device_ms(torch, lambda: checked(pfn(*pargs), "p4p"))
        p4p_wrap = device_ms(torch, lambda: p3p.solve_batch_p4p_pool(*pp["p4p"], pp["rs"]))
        p4p_plain = event_ms(torch, lambda: p3p.solve_batch_p4p_pool_reference(*pp["p4p"], pp["rs"]), 3)
        rows = min(4 * S, M) * B
        p4p_bytes = B * M + B * S * 4 * 8 + rows * 20 + B * S * 28
        p4p_fp32, p4p_sfu = ops_ms({"h": B * S}, {"h": P4P_PIECE})
        p4p_by_bytes = p4p_bytes / HBM_BYTES_PER_S * 1e3
        # meanshift on that pool, the external start off (the first frame's way)
        T = hp["meanshift_max_init_trials"]
        trials = ms.draw_meanshift_trials(pp["gen"], pool_valid, T)
        use = torch.zeros(B, dtype=torch.bool, device="cuda")
        res = ms.meanshift(pool, pool_valid, hp["meanshift_kernel_var"], pp["init"], use, trials,
                           epsilon=hp["meanshift_epsilon"], max_iters=hp["meanshift_max_iters"],
                           good_init_confidence=hp["meanshift_good_init_confidence"])
        it_ms = res.iters.tolist()
        mean, conf = torch.empty((B, 6), device="cuda"), torch.empty(B, device="cuda")
        iters, nv = torch.empty(B, dtype=torch.int32, device="cuda"), torch.empty(B, dtype=torch.int32, device="cuda")
        mfn = _build.function("meanshift_launch", ms._ARGTYPES)
        init_c = pp["init"].contiguous()
        margs = (pool.data_ptr(), pool_valid.data_ptr(), init_c.data_ptr(),
                 use.data_ptr(), trials.data_ptr(), mean.data_ptr(), conf.data_ptr(), iters.data_ptr(),
                 nv.data_ptr(), B, S, 6, T, hp["meanshift_max_iters"], 2.0 * hp["meanshift_kernel_var"],
                 hp["meanshift_epsilon"], hp["meanshift_good_init_confidence"], THREADS, stream)
        ms_ms = device_ms(torch, lambda: checked(mfn(*margs), "meanshift"))
        ms_plain = event_ms(torch, lambda: ms.meanshift_reference(
            pool, pool_valid, hp["meanshift_kernel_var"], pp["init"], use, trials,
            epsilon=hp["meanshift_epsilon"], max_iters=hp["meanshift_max_iters"],
            good_init_confidence=hp["meanshift_good_init_confidence"]), 3)
        ms_bytes = B * S * (24 + 4) + B * T * 8 + B * 6 * 4 * 2 + B * 13
        ms_fp32, ms_sfu = ops_ms({"w": S * (B * T + sum(it_ms))}, {"w": ms_piece(6)})
        ms_by_bytes = ms_bytes / HBM_BYTES_PER_S * 1e3
        ms_chain = (max(it_ms) * probe[7] + -(-T // 8) * probe[8]) * 1e-6
        # the robust-Gaussian refit, as _solve_and_fuse calls it
        s = pp["s"]
        sp, m0 = (pool * s).contiguous(), (res.mean * s).contiguous()
        c0 = pp["covar0"].contiguous()
        r = rg.fit_robust_gaussian(sp, pool_valid, m0, c0, trunc_sigma=hp["rg_trunc_sigma"],
                                   covar_reg_lambda=hp["rg_covar_reg_lambda"], epsilon=hp["rg_epsilon"],
                                   max_iters=hp["rg_max_iters"])
        it_rg = r.iters.tolist()
        committed = [i - 1 if (i < hp["rg_max_iters"]) else i for i in it_rg]
        outs = [torch.empty((B, 6), device="cuda"), torch.empty((B, 6, 6), device="cuda"),
                torch.empty(B, device="cuda"), torch.empty(B, dtype=torch.int32, device="cuda"),
                torch.empty(B, dtype=torch.bool, device="cuda"),
                torch.empty((B, S), dtype=torch.uint8, device="cuda")]
        lam = hp["rg_covar_reg_lambda"]
        rfn = _build.function("robust_gaussian_launch", rg._ARGTYPES)
        rargs = (sp.data_ptr(), pool_valid.data_ptr(), m0.data_ptr(), c0.data_ptr(),
                 *(o.data_ptr() for o in outs), B, S, hp["rg_max_iters"],
                 hp["rg_trunc_sigma"] ** 2, lam, 1.0 - lam, hp["rg_epsilon"], THREADS, stream)
        rg_ms = device_ms(torch, lambda: checked(rfn(*rargs), "robust_gaussian"))
        rg_plain = event_ms(torch, lambda: rg.fit_robust_gaussian_reference(
            sp, pool_valid, m0, c0, trunc_sigma=hp["rg_trunc_sigma"], covar_reg_lambda=lam,
            epsilon=hp["rg_epsilon"], max_iters=hp["rg_max_iters"]), 3)
        rg_bytes = B * S * 28 + B * 42 * 4 * 2 + B * 13
        rg_fp32, rg_sfu = ops_ms({"e": S * sum(it_rg), "m": S * sum(committed)},
                                 {"e": RG_ESTEP, "m": RG_MSTEP})
        rg_by_bytes = rg_bytes / HBM_BYTES_PER_S * 1e3
        rg_chain = max(i * probe[7] + c * probe[36] for i, c in zip(it_rg, committed)) * 1e-6

        def bound(by_bytes, fp32, sfu):
            b = max(by_bytes, fp32, sfu)
            return b, "bytes" if by_bytes >= max(fp32, sfu) else "operations"

        pb, pbb = bound(p4p_by_bytes, p4p_fp32, p4p_sfu)
        mb, mbb = bound(ms_by_bytes, ms_fp32, ms_sfu)
        rb, rbb = bound(rg_by_bytes, rg_fp32, rg_sfu)
        rec[B] = dict(
            p4p=dict(ms=p4p_ms, wrapper_ms=p4p_wrap, plain_ms=p4p_plain, bound_ms=pb, bound_by=pbb,
                     bytes_ms=p4p_by_bytes, fp32_ms=p4p_fp32, sfu_ms=p4p_sfu, M=M, S=S),
            meanshift=dict(ms=ms_ms, plain_ms=ms_plain, bound_ms=mb, bound_by=mbb, iters=it_ms,
                           chain_floor_ms=ms_chain, bytes_ms=ms_by_bytes, fp32_ms=ms_fp32, sfu_ms=ms_sfu),
            rg=dict(ms=rg_ms, plain_ms=rg_plain, bound_ms=rb, bound_by=rbb, iters=it_rg,
                    chain_floor_ms=rg_chain, bytes_ms=rg_by_bytes, fp32_ms=rg_fp32, sfu_ms=rg_sfu))
        log(f"[times] pose kernels B={B} (M={M}, S={S}), device ms per launch ({N_LAUNCH} launches): "
            f"P4P {p4p_ms:.5f} (through the wrapper, argsort and count included, {p4p_wrap:.5f}; "
            f"plain {p4p_plain:.4f}; bound {pb * 1e3:.3f} us by {pbb}: bytes {p4p_by_bytes * 1e3:.3f}, "
            f"FP32 {p4p_fp32 * 1e3:.3f}, special-function {p4p_sfu * 1e3:.3f} us); meanshift "
            f"{ms_ms:.5f} (iterations {it_ms}; plain {ms_plain:.4f}; bound {mb * 1e3:.3f} us by {mbb}; "
            f"chain floor {ms_chain * 1e3:.3f} us); robust Gaussian {rg_ms:.5f} (iterations {it_rg}; "
            f"plain {rg_plain:.4f}; bound {rb * 1e3:.3f} us by {rbb}; chain floor "
            f"{rg_chain * 1e3:.3f} us)")
    log(f"[times] pose block-sum latency, one block of {THREADS} threads (pose_reduce_probe_kernel): "
        f"{ {q: round(v, 2) for q, v in probe.items()} } ns for Q values")
    rec["probe_ns"] = probe
    return rec


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
    """fb_smooth's chain floors at h x w, from two one-thread probes: the
    serial steps (5e5 forward, then 5e5 backward) and the Moebius
    compositions (5e5 forward and backward, interleaved as the kernel
    composes them). The serial design walks h + w step pairs; the chunked
    design, per row and per column pass, composes L maps, scans log2 C
    steps and walks L step pairs, L = ceil(n / C) for the C = fb.CHUNKS
    chunks of a line (its shuffles and memory not counted). Returns (serial floor ms,
    ns per step pair, ns per composition pair, chunked floor ms)."""
    from voldor_tpu_torch.ops import _build
    from voldor_tpu_torch.ops import fb_smooth as fb

    fn = _build.function("fb_chain_probe_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int]
                         + [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p])
    e = torch.tensor([0.7, 0.6], device="cuda")
    out = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    consts = fb._constants_array(FB_EMM, FB_NCP)
    n = 500_000
    ns = []
    for which in (0, 1):
        checked(fn(e.data_ptr(), out.data_ptr(), 1000, consts, which, stream), "chain probe")
        ms = event_ms(torch, lambda: checked(fn(e.data_ptr(), out.data_ptr(), n, consts, which,
                                                 stream), "chain probe"), 3)
        if not math.isfinite(float(out)):
            raise AssertionError(f"chain probe {which} left {float(out)}")
        ns.append(ms / n * 1e6)
    step, comb = ns
    lw, lh = -(-W // fb.CHUNKS), -(-H // fb.CHUNKS)
    scans = 2 * (fb.CHUNKS.bit_length() - 1)
    chunked = ((lw + lh + scans) * comb + (lw + lh) * step) * 1e-6
    return step * (H + W) * 1e-6, step, comb, chunked


def parent_times(parent):
    """tools/fb_smooth_ab.py on the checkout `parent` and this one: each
    one's fb_smooth kernel through its own wrapper, device-only (CUDA-graph
    replays), alternating parent, this, this, parent. Returns the tool's
    record: {"a": parent's, "b": this tree's}."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "fb_smooth_ab.py"), str(parent),
                        str(ROOT)], capture_output=True, text=True, timeout=900)
    for ln in r.stdout.splitlines()[:-1]:
        log(f"[times] fb_smooth_ab {ln}")
    if r.returncode != 0:
        raise RuntimeError(f"tools/fb_smooth_ab.py failed:\n{r.stdout[-3000:]}{r.stderr[-3000:]}")
    return json.loads(r.stdout.splitlines()[-1])


COST_TIMED_K = (1, 4, 10, 16)
# the launch shapes phase 6 times: (mode, K, masks given)
COST_SHAPES = tuple((m, k, masked) for k in COST_TIMED_K
                    for m, masked in (("score", False), ("accept", False), ("accept", True)))


def shape_name(shape):
    mode, k, masked = shape
    return f"{mode} K={k}" + (" masked" if masked else "")


def shift_masks(torch, depth, k):
    """k masks of the jump-flood family's kind (vo/em.py:optimize_depth_batched):
    candidate i takes the neighbour (i // 4 + 1) pixels away in direction
    i % 4, kept where that neighbour is inside the image."""
    from voldor_tpu_torch.vo import em

    return torch.stack([em._shift_depth(depth, sy * (i // 4 + 1), sx * (i // 4 + 1))[1]
                        for i, (sy, sx) in ((i, em._LOCAL_DIRS[i % 4]) for i in range(k))])


def depth_round_ms(ms_by_shape, shapes, rounds):
    """The device time of one depth round's cost launches: each launch shape
    the main path ran (``shapes``: counts by shape_name, read_counts' of the
    wrapper's ``cost_launch_shapes``) at its time in ``ms_by_shape``, over
    the main path's ``rounds`` depth rounds that launch it."""
    missing = [name for name in shapes if name not in ms_by_shape]
    if missing:
        raise AssertionError(f"the main path launched the cost kernel as {missing}, "
                             f"which phase 6 does not time")
    return sum(n * ms_by_shape[name] for name, n in shapes.items()) / rounds


def pow_check(torch, n=1 << 22):
    """Whether torch.pow(v, -2.0) on the card is bitwise 1 / (v * v) (IEEE
    division), the premise of the kernel's (1 + u^-c)^-2: v = 1 + u^-c
    over n draws of u (log-uniform in e^-30..e^30) and c (the Fisk shape's
    range), and n uniform draws of v in [1, 1e6]."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    u = torch.exp(torch.empty(n, device="cuda").uniform_(-30.0, 30.0, generator=gen))
    c = torch.empty(n, device="cuda").uniform_(0.78, 0.9956, generator=gen)
    v = torch.cat([1.0 + torch.pow(u, -c), torch.empty(n, device="cuda").uniform_(1.0, 1e6, generator=gen)])
    a = torch.pow(v, -2.0)
    b = torch.ones_like(v) / (v * v)
    differ = int((a != b).sum())
    log(f"[times] torch.pow(v, -2.0) on the card against 1 / (v * v), {v.numel()} draws: "
        f"{differ} differ (bitwise equal {differ == 0})")
    return dict(draws=v.numel(), differ=differ)


def term_instructions(torch, sass, p):
    """SASS instructions of one flow term and one prior term: the
    differences between the term probes' builds (2 flow terms a loop
    iteration against 1, 2 prior terms against 1); the probes are launched
    once to check they run."""
    from voldor_tpu_torch.ops import _build
    from voldor_tpu_torch.ops import cost as cost_mod

    base = sass["cost_term_probe<1,1>"]
    ins = {"flow": sass["cost_term_probe<2,1>"] - base, "prior": sass["cost_term_probe<1,2>"] - base}
    fn = _build.function("cost_term_probe_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int]
                         + [ctypes.POINTER(cost_mod._CostParams), ctypes.c_void_p])
    prm = cost_mod._CostParams()
    prm.fx, prm.fy, prm.cx, prm.cy = p.fx, p.fy, p.cx, p.cy
    prm.lam, prm.arf, prm.bf, prm.omega = p.lam, p.abs_resize_factor, p.basefocal, p.omega
    data = torch.tensor([10.0, 5.0, 0.5, 0.2, 0.9, 0.03, 0.01, 0.8, 0.5, 3.0, 0.9, 0.02, 0.01,
                         0.3, -0.2, 7.0] + [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0, 0.08, 0.01, 0.3] * 2,
                        device="cuda")
    out = torch.zeros(96, device="cuda")
    checked(fn(data.data_ptr(), out.data_ptr(), 16, ctypes.byref(prm),
               torch.cuda.current_stream().cuda_stream), "cost term probes")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("cost term probes left non-finite values")
    log(f"[build] SASS instructions per term (term probes): flow {ins['flow']}, prior {ins['prior']}")
    return ins


def parent_cost_times(parent, evaluated):
    """tools/cost_kernel_ab.py on the checkout `parent` and this one (each
    one's cost kernel through its own wrappers, CUDA-graph replays, parent,
    this, this, parent, at every shape of COST_SHAPES), and the parent
    kernel's issue-rate floor from its own SASS: from its term probes where
    it has them, else from the slope of the thread-per-pixel kernel's
    unrolled per-candidate code (KT = 10 against KT = 4, halved: ~one term),
    else none. Returns the tool's record with the floors."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "cost_kernel_ab.py"), str(parent),
                        str(ROOT)], capture_output=True, text=True, timeout=900)
    for ln in r.stdout.splitlines()[:-1]:
        log(f"[times] cost_kernel_ab {ln}")
    if r.returncode != 0:
        raise RuntimeError(f"tools/cost_kernel_ab.py failed:\n{r.stdout[-3000:]}{r.stderr[-3000:]}")
    ab = json.loads(r.stdout.splitlines()[-1])
    libs = sorted(Path(parent, "voldor_tpu_torch", "_build").glob("libvoldor_kernels_*.so"),
                  key=lambda q: q.stat().st_mtime)
    sass = sass_counts(libs[-1], quiet=True)
    per_term = None
    if "cost_term_probe<1,1>" in sass:
        base = sass["cost_term_probe<1,1>"]
        per_term = {"flow": sass["cost_term_probe<2,1>"] - base,
                    "prior": sass["cost_term_probe<1,2>"] - base}
    elif "cost_kernel<KT=10, accept>" in sass:
        slope = (sass["cost_kernel<KT=10, accept>"] - sass["cost_kernel<KT=4, accept>"]) / 6
        per_term = {"flow": slope / 2, "prior": slope / 2}
    ab["a"]["sass_per_term"] = per_term
    ab["a"]["issue_floor_us"] = per_term and {
        k: (n["flow"] * per_term["flow"] + n["prior"] * per_term["prior"]) / FP32_INSTR_PER_S * 1e6
        for k, n in evaluated.items()}
    for name in ("a", "b"):
        log(f"[times] cost kernel of {'the parent' if name == 'a' else 'this tree'} "
            f"(tools/cost_kernel_ab.py, device-only per launch, CUDA-graph replays): "
            f"{ab[name]['ms']}")
    log(f"[times] the parent kernel's issue-rate floor (SASS instructions per term "
        f"{per_term}): {ab['a']['issue_floor_us']} us")
    return ab


def phase_times(np, torch, bi, sass, parent=None):
    """Device-only times of both kernels, their plain versions' times and
    their bounds; with parent (a checkout), that checkout's fb_smooth and
    cost kernels beside this tree's. Returns the kernels' records."""
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
    consts = fb._constants_array(FB_EMM, FB_NCP)
    fb_rec = {}
    for m in (5, 2):
        x = rig[:m].contiguous()
        mid, out = torch.empty_like(x), torch.empty_like(x)
        args = (x.data_ptr(), mid.data_ptr(), out.data_ptr(), m, H, W, consts, stream)
        fb_rec[m] = device_ms(torch, lambda: checked(fb_fn(*args), "fb_smooth"))
    x5 = rig.contiguous()
    ab = None
    if parent is not None:
        ab = parent_times(parent)
        log(f"[times] fb_smooth M=5, device-only per call (CUDA-graph replays, order parent, "
            f"this, this, parent): the parent's kernel {ab['a']['ms']:.5f} ms, this tree's "
            f"{ab['b']['ms']:.5f} ms; back to back through each wrapper {ab['a']['eager_ms']:.5f} "
            f"/ {ab['b']['eager_ms']:.5f} ms; each against its own plain version within "
            f"{ab['a']['max_abs_err']:.3e} / {ab['b']['max_abs_err']:.3e}")
    plain1 = event_ms(torch, lambda: fb.fb_smooth_reference(x5, FB_EMM, FB_NCP), 3)
    kern = device_ms(torch, lambda: fb.fb_smooth(x5, FB_EMM, FB_NCP))
    plain2 = event_ms(torch, lambda: fb.fb_smooth_reference(x5, FB_EMM, FB_NCP), 3)
    fb_bytes = 2 * 4 * WINDOW * px
    fb_fp32, fb_sfu = ops_ms({"el": 2 * WINDOW * px}, {"el": FB_PIECE})
    fb_by_bytes = fb_bytes / HBM_BYTES_PER_S * 1e3
    fb_bound = max(fb_by_bytes, fb_fp32, fb_sfu)
    chain_ms, pair_ns, comb_ns, chunked_ms = chain_floor_ms(torch)
    log(f"[times] fb_smooth M=5 {H}x{W}: device {fb_rec[5]:.4f} ms per call ({N_LAUNCH} "
        f"launches; M=2 {fb_rec[2]:.4f} ms; through the wrapper {kern:.4f} ms), plain "
        f"{plain1:.4f} / {plain2:.4f} ms (order plain, kernel, plain); bound {fb_bound * 1e3:.3f} us (bytes {fb_by_bytes * 1e3:.3f} us for {fb_bytes} "
        f"B, FP32 {fb_fp32 * 1e3:.3f} us, special-function {fb_sfu * 1e3:.3f} us); serial floor "
        f"{chain_ms * 1e3:.3f} us ({H + W} forward + backward step pairs at {pair_ns:.3f} ns "
        f"each, timed on one thread); the chunked design's chain floor {chunked_ms * 1e3:.3f} us "
        f"(compositions at {comb_ns:.3f} ns per forward + backward pair)")

    # the cost kernel in accept and score mode at K = 1, 4, 10, 16
    pow_rec = pow_check(torch)
    term_ins = term_instructions(torch, sass, p)
    info_fn = _build.function("cost_kernel_info", [ctypes.c_int, ctypes.POINTER(cost_mod._CostParams),
                                                   ctypes.POINTER(ctypes.c_int)])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    D = ps[0].shape[0]
    cost_rec, ms_by_shape = {}, {}
    for k in COST_TIMED_K:
        cands = cost_cands(bi, k)
        depth = bi["d0"].clone()
        cost = cost_mod.cost_map_score(depth[None], *planes, prior_samples=ps)[0].clone()
        masks = shift_masks(torch, bi["d0"], k)
        out = torch.empty_like(cands)
        geom = cost_mod.geometry(k, WINDOW, D, H, W)
        bound = {("score", False): cost_mod._bind(cost_mod._SCORE, cands, *planes, ps, out=out),
                 ("accept", False): cost_mod._bind(cost_mod._ACCEPT, cands, *planes, ps,
                                                   depth=depth, cost=cost),
                 ("accept", True): cost_mod._bind(cost_mod._ACCEPT, cands, *planes, ps,
                                                  masks=masks, depth=depth, cost=cost)}
        runs = {key: [] for key in bound}
        for order in (list(bound), list(bound)[::-1]):
            for key in order:
                fn, args, _poses = bound[key]
                runs[key].append(device_ms(torch, lambda: checked(fn(*args), shape_name((key[0], k, key[1])))))
        occ = {}
        for mode, name in ((cost_mod._SCORE, "score"), (cost_mod._ACCEPT, "accept")):
            info = (ctypes.c_int * 7)()
            checked(info_fn(mode, bound[name, False][1][-2], info), "cost_kernel_info")
            if tuple(info[4:7]) != (geom.threads, geom.smem, geom.grid):
                raise AssertionError(f"cost kernel K={k}: the entry point launches threads, shared "
                                     f"bytes, grid {tuple(info[4:7])}, ops/cost.py:geometry says "
                                     f"{(geom.threads, geom.smem, geom.grid)}")
            occ[name] = dict(registers=info[0], spill_bytes=info[1], blocks_per_sm=info[2],
                             warps_per_sm=info[2] * geom.threads // 32,
                             waves=geom.grid / (info[2] * sms))
        n = count_pieces(torch, cands, tinb, Rs, ts, WINDOW, p, ps)
        fp32_ms, sfu_ms = ops_ms(n, COST_PIECES)
        in_bytes = px * (4 * k + WINDOW * (5 * 4 + 1) + D * 8)
        by_bytes = {"accept": (in_bytes + px * 16) / HBM_BYTES_PER_S * 1e3,
                    "score": (in_bytes + px * 4 * k) / HBM_BYTES_PER_S * 1e3}
        bounds = {m: max(b, fp32_ms, sfu_ms) for m, b in by_bytes.items()}
        floor_ms = (n["flow"] * term_ins["flow"] + n["prior"] * term_ins["prior"]) / FP32_INSTR_PER_S * 1e3
        cost_rec[k] = {"score": min(runs["score", False]), "accept": min(runs["accept", False]),
                       "accept_masked": min(runs["accept", True])}
        for (mode, masked), v in runs.items():
            ms_by_shape[shape_name((mode, k, masked))] = min(v)
        log(f"[times] cost K={k} N={WINDOW} D={D}: device ms per launch (min of two rounds of "
            f"{N_LAUNCH}) accept {runs['accept', False]}, accept with masks {runs['accept', True]}, "
            f"score {runs['score', False]}; geometry {geom._asdict()}; occupancy {occ}; "
            f"evaluated {n}; least operations FP32 {fp32_ms * 1e3:.2f} us, special-function "
            f"{sfu_ms * 1e3:.2f} us; bytes accept {by_bytes['accept'] * 1e3:.2f} us, score "
            f"{by_bytes['score'] * 1e3:.2f} us; bound (largest) accept {bounds['accept'] * 1e3:.2f} "
            f"us, score {bounds['score'] * 1e3:.2f} us; issue-rate floor (this kernel's SASS per "
            f"term, {term_ins['flow']} flow / {term_ins['prior']} prior, at the FP32 issue rate; "
            f"not a bound) {floor_ms * 1e3:.2f} us")
        cost_rec[k].update(bound=bounds, issue_floor_ms=floor_ms, geometry=geom._asdict(),
                           occupancy=occ, evaluated=n,
                           bound_by="operations" if max(fp32_ms, sfu_ms) > by_bytes["accept"] else "bytes")
    cost_ab = None
    if parent is not None:
        cost_ab = parent_cost_times(parent, {k: cost_rec[k]["evaluated"] for k in cost_rec})

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
                     ms_m2=fb_rec[2], chain_floor_ms=chain_ms, chain_step_pair_ns=pair_ns,
                     chain_floor_new_ms=chunked_ms, combine_pair_ns=comb_ns,
                     parent_ms=ab and ab["a"]["ms"], parent_ab=ab)
    c10 = cost_rec[10]
    cost_record = dict(
        ms=c10["accept"], plain_ms=min(pa1, pa2), bound_ms=c10["bound"]["accept"],
        bound_by=c10["bound_by"], score_ms=c10["score"],
        ms_by_k={k: {m: r[m] for m in ("accept", "accept_masked", "score")} for k, r in cost_rec.items()},
        ms_by_shape=ms_by_shape,
        bound_us_by_k={k: {m: r["bound"][m] * 1e3 for m in r["bound"]} for k, r in cost_rec.items()},
        issue_floor_us={k: r["issue_floor_ms"] * 1e3 for k, r in cost_rec.items()},
        sass_per_term=term_ins,
        registers={m: c10["occupancy"][m]["registers"] for m in ("score", "accept")},
        spill_bytes={m: c10["occupancy"][m]["spill_bytes"] for m in ("score", "accept")},
        warps_per_sm={k: r["occupancy"]["accept"]["warps_per_sm"] for k, r in cost_rec.items()},
        waves={k: r["occupancy"]["accept"]["waves"] for k, r in cost_rec.items()},
        pow_m2=pow_rec, parent=cost_ab)
    return fb_record, cost_record


def run_sequence(np, torch, scene, check=False, n_windows=N_WINDOWS, extra_config=""):
    """n_windows consecutive windows (three: with 0, 1 and 2 depth priors),
    driven the way the SLAM layer drives them
    (voldor_tpu/slam/system.py:535-575), configured CONFIG + extra_config.

    Returns (cam->world poses of the 5 n_windows + 1 frames, per-window wall
    seconds, per-window EM iterations, bootstrap route)."""
    import voldor_tpu_torch
    from voldor_tpu_torch.ops.lie import T44_to_pose6, pose6_to_T44

    _, _, _, flows, _, _, _ = scene

    def T6(T):
        return T44_to_pose6(torch.as_tensor(np.asarray(T, np.float32))).numpy()

    Twc = np.eye(4, dtype=np.float32)  # world -> current camera
    frames_Tcw = []  # cam -> world per frame
    kf = []  # (fid, depth, conf) of earlier window starts, newest first
    walls, iters, route = [], [], None
    for wi in range(n_windows):
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
            config=CONFIG + extra_config, pad_window_to=WINDOW, device="cuda", **kw,
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


def make_slam(mode, flows, disps=None, user_config=""):
    """VOLDOR_SLAM on the card, configured as bench.py:411-425 (mono) and
    bench.py:171-182 (stereo, mono-scaled) configure it, with user_config
    as its voldor_user_config."""
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    slam = VOLDOR_SLAM(mode=mode, device="cuda")
    slam.use_image_info = False
    slam.voldor_user_config = user_config
    if mode in ("stereo", "mono-scaled"):
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


POSE_KERNELS = ("p4p", "meanshift", "rg")


def reset_counts():
    from voldor_tpu_torch.ops import chain_trace as ct
    from voldor_tpu_torch.ops import cost as cost_mod
    from voldor_tpu_torch.ops import falign_kernels as fk
    from voldor_tpu_torch.ops import fb_smooth as fb
    from voldor_tpu_torch.ops import meanshift as ms
    from voldor_tpu_torch.ops import p3p
    from voldor_tpu_torch.ops import pose_collect as pc
    from voldor_tpu_torch.ops import robust_gaussian as rg

    cost_mod.cost_kernel_launches = cost_mod.cost_score_launches = 0
    cost_mod.cost_launch_shapes.clear()
    fb.fb_smooth_kernel_launches = 0
    ct.chain_trace_launches = 0
    fk.reset_counts()
    p3p.p4p_kernel_launches = ms.meanshift_kernel_launches = rg.rg_kernel_launches = 0
    pc.pose_collect_launches = 0


def read_counts():
    """Launches since reset_counts: the cost kernel (score mode apart; shapes:
    by (mode, K, masked)), fb_smooth, the chain trace (ct), the falign
    kernels (linearize: the one-shot linearise and scores launches;
    lm_chunk: the LM chunks), the pose sweep's three (p4p, meanshift,
    rg) and its collect (pc)."""
    from voldor_tpu_torch.ops import chain_trace as ct
    from voldor_tpu_torch.ops import cost as cost_mod
    from voldor_tpu_torch.ops import falign_kernels as fk
    from voldor_tpu_torch.ops import fb_smooth as fb
    from voldor_tpu_torch.ops import meanshift as ms
    from voldor_tpu_torch.ops import p3p
    from voldor_tpu_torch.ops import pose_collect as pc
    from voldor_tpu_torch.ops import robust_gaussian as rg

    return dict(cost=cost_mod.cost_kernel_launches, score=cost_mod.cost_score_launches,
                shapes={shape_name(k): n for k, n in cost_mod.cost_launch_shapes.items()},
                fb=fb.fb_smooth_kernel_launches, ct=ct.chain_trace_launches,
                p4p=p3p.p4p_kernel_launches, meanshift=ms.meanshift_kernel_launches,
                rg=rg.rg_kernel_launches, pc=pc.pose_collect_launches,
                **fk.read_counts())


def check_pose_counts(what, counts):
    """The pose sweep ran on its three kernels and its collect kernel: every
    one was launched."""
    missing = [k for k in POSE_KERNELS + ("pc",) if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{what}: pose kernels never launched: {missing} ({counts})")


def check_counts(what, counts, em_iters):
    if counts["cost"] < 8 * em_iters:
        raise AssertionError(f"{what}: cost kernel launched {counts['cost']} times, "
                             f"expected >= {8 * em_iters}")
    if counts["fb"] < 1:
        raise AssertionError(f"{what}: the fb_smooth kernel was never launched")
    # each flow-fed EM iteration refreshes the rigidness through the kernel
    if counts["ct"] < em_iters:
        raise AssertionError(f"{what}: chain trace kernel launched {counts['ct']} times, "
                             f"expected >= {em_iters}")
    check_pose_counts(what, counts)


def check_falign_counts(what, counts):
    """The mapping half ran on the falign kernels: every one was launched."""
    missing = [k for k in ("linearize", "lm_chunk") if counts[k] < 1]
    if missing:
        raise AssertionError(f"{what}: falign kernels never launched: {missing}")


def run_slam_pass(np, torch, mode, flows, disps=None, check=False, user_config=""):
    """One pass of process_vo to the end of the sequence. Returns the SLAM
    object, the pass's wall seconds and its per-pass counts."""
    slam = make_slam(mode, flows, disps, user_config)
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
    """slam-mono / slam-stereo / mono-scaled: one checked pass with the
    launches counted, then n_timed timed passes under the bench's gate
    (Sim3 ATE < 0.02 x extent for mono; metric ATE < 0.02 x extent for
    stereo, < 0.05 x extent for mono-scaled, bench.py:204). Returns (launch
    counts, median frames/s, ATE)."""
    from voldor_tpu_torch.utils.evaluation import ate_rmse

    with_scale = mode == "mono"  # stereo and mono-scaled are metric
    gate = 0.05 if mode == "mono-scaled" else 0.02
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
        f"{gate * extent:.6f} (extent {extent:.4f})")
    check_counts(mode, counts, st["em_iters"])
    if not ate < gate * extent:
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
        if not ate_t < gate * extent:
            raise AssertionError(f"{mode}: timed pass fails the ATE gate")
        dts.append(dt)
    med = statistics.median(dts)
    log(f"[slam-{mode}] median of {n_timed}: {n_frames / med:.4f} frames/s ({med:.4f} s per pass)")
    return counts, n_frames / med, ate


def phase_no_sync(np, torch, scene):
    """The three windows again, every kernel-wrapper call of their depth
    rounds (the rigidness refresh's chain trace included), every pose
    collect and every call of the pose sweep's _solve_and_fuse (its P4P,
    meanshift and robust-Gaussian kernels and the draws between them) under
    torch.cuda.set_sync_debug_mode("error")."""
    from voldor_tpu_torch.vo import em
    from voldor_tpu_torch.vo import engine as engine_mod
    from voldor_tpu_torch.vo import pose_step

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
    em_names = ("update_rigidness_and_tracks",)
    orig = {n: getattr(engine_mod, n) for n in names}
    em_orig = {n: getattr(em, n) for n in em_names}
    fuse = pose_step._solve_and_fuse
    collect = pose_step.pose_collect
    for n in names:
        setattr(engine_mod, n, guarded(n, orig[n]))
    for n in em_names:
        setattr(em, n, guarded(n, em_orig[n]))
    pose_step._solve_and_fuse = guarded("_solve_and_fuse", fuse)
    pose_step.pose_collect = guarded("pose_collect", collect)
    try:
        run_sequence(np, torch, scene)
    finally:
        for n in names:
            setattr(engine_mod, n, orig[n])
        for n in em_names:
            setattr(em, n, em_orig[n])
        pose_step._solve_and_fuse = fuse
        pose_step.pose_collect = collect
    log(f"[no-sync] wrapper calls under set_sync_debug_mode('error') over the 3 windows: {calls}")
    if set(calls) != set(names) | set(em_names) | {"_solve_and_fuse", "pose_collect"}:
        raise AssertionError(f"not every kernel wrapper ran: {calls}")



# --------------------------------------------------------------------------
# the mapping half: falign, PGO, the full SLAM pass
# --------------------------------------------------------------------------

SLAM_E2E_FLOWS = 60  # bench.py:357
# falign, card vs the CPU run, per lane and per kind of batch: LM
# iterations (coarse and fine, each), the angle between the two relative
# rotations (rad), the largest difference of their translations, and how
# much farther from the true relative rotation the card's solve may land
# than the CPU's (truth, rad). Set at about twice the largest of the card's
# readings against the CPU over six seeded batches of four lanes
# (tools/falign_card_vs_cpu.py). geo / photo (the true translation is 1.1
# long): 30 / 37 iterations, 5.9e-4 / 1.2e-3 rad, 5.2e-3 / 7.6e-3, truth
# 1.7e-4. lc (translations in units of the depths normalised to median 10;
# the revisit pairs' true translation is ~0): 3.7e-3 rad, 5.8e-2, truth
# 1.8e-3, scale ratio 4.5e-3, scores 1.2e-2; the CPU against itself, its
# init moved by 1e-6, as far (3.8e-3 rad, 4.0e-2, 3.6e-3, 1.1e-2, 53
# iterations), so the LC lanes' iterations are not held.
# The iterations are a loose check: a lane whose cost has flattened ends
# on a run of float-noise accepts and rejects, and the CPU alone, its init
# moved by 1e-6, moves them by up to 27 (geo, photo). The true relative
# rotations of the geo / photo pairs are 5.5e-3 to 1.2e-2 rad, so their
# rotation limits reject a wrong rotation.
# The scale ratio (relative) and the visibility / consistency scores of
# the geo and photo lanes are held at 1e-4 and 1e-3.
FALIGN_LIMITS = {
    "geo": dict(iters=40, rot=1.2e-3, trans=1e-2, truth=5e-4, scale=1e-4, score=1e-3),
    "photo": dict(iters=45, rot=2.5e-3, trans=1.5e-2, truth=5e-4, scale=1e-4, score=1e-3),
    # the loop-closure batch: its photometric stage, from each run's own
    # geometric stage
    "lc": dict(iters=None, rot=7.5e-3, trans=1.2e-1, truth=3.6e-3, scale=9e-3, score=2.5e-2),
}
# the scene's revisit pairs among the keyframes of its SLAM pass (0, 5, ...,
# 25, 40, ..., 55): the return leg's frame 60 - k sees frame k's view
LC_PAIRS = [(5, 55), (10, 50), (15, 45), (20, 40)]
FALIGN_COV_RTOL = 1e-3  # covariances at the same parameters
PGO_POSE_TOL = 1e-3  # positions and rotation entries, card vs the CPU run
# pgo() in the SLAM's form on the card: a graph past 1024 poses, and KITTI
# 00's 4,541 frames, the longest KITTI sequence
PGO_DENSE_SIZES = (600, 1100, 4541)
# the mapped drive's limits on its last global PGO
# (benchmark/limits/kitti-stereo-slam.mapped-drive.json)
PGO_COST_GAP = 1.00001
PGO_POSE_GAP = 1e-3


def build_slam_scene(np, torch, n_flows, h=H, w=W, focal=FX):
    """The bench's full-SLAM scene (bench.py:240-298, out and back with a
    revisit, textured gray images), rendered with the port's so3_exp at
    h x w with the focal length focal (the principal point at the centre)."""
    from synthetic import plane_depth, render_window

    from voldor_tpu_torch.ops.lie import so3_exp

    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

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

    flows, _, Ts = render_window(K, poses, planes, h, w, r2R)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(np.asarray(K, np.float64)).T
    images_bgri, images_grayf, depths = [], [], []
    for k in range(n_flows + 1):
        R, t = Ts[k][:3, :3], Ts[k][:3, 3]
        d = plane_depth(K, R, t, planes, h, w).astype(np.float64)
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


def falign_lc_batch(np, torch, sc, seed=None):
    """The stage-1 (geometry) falign_pairs arguments of a loop-closure batch
    at the SLAM layer's settings (voldor_tpu/slam/system.py:928-1091 with
    kind="lc"): LC_PAIRS, true depths with 1% seeded noise (seed 200 unless
    given), each normalised to median 10 as mono LC links do, blurred at
    width 5, seeded confidences, identity init, stride 3, vbf = 5 x
    basefocal, crw 10, 7-dof. Returns (pairs, kwargs, the gray images
    blurred at width 9 for stage 2). The blur is the SLAM layer's
    (_gblur: cv2.GaussianBlur where cv2 imports)."""
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    blur = VOLDOR_SLAM(mode="mono", device="cpu")._gblur
    rng = np.random.default_rng(200 if seed is None else seed)
    D = []
    for pair in LC_PAIRS:
        for f in pair:
            d = (sc["depths"][f] * (1.0 + 0.01 * rng.standard_normal((H, W)))).astype(np.float32)
            D.append(blur(d * (10 / np.median(d)), 5))
    D = np.stack(D).reshape(len(LC_PAIRS), 2, H, W)
    Wt = rng.uniform(0.5, 1.0, D.shape).astype(np.float32)
    images = np.stack([[blur(sc["images_grayf"][f], 9) for f in p] for p in LC_PAIRS])
    kw = dict(depths=D, fx=FX, fy=FY, cx=W / 2, cy=H / 2, weights=Wt, optimize_7dof=True,
              stride=3, vbf=BASEFOCAL * 5, crw=10)
    return list(LC_PAIRS), kw, images


def falign_run(np, torch, sc, kind, device, seed=None, nudge=0.0):
    """One falign batch of a kind (geo, photo: falign_batch; lc: the two
    stages of falign_lc_batch, the photometric one from this run's own
    geometric result, coarse stride 6 and 12 fine iterations) on a device,
    the init moved by nudge. Returns (pairs, the last call's kwargs, its
    results)."""
    from voldor_tpu_torch.falign import api as falign_api

    if kind != "lc":
        pairs, kw = falign_batch(np, torch, sc, 4, kind == "photo", seed=seed)
        kw = dict(kw, poses_init=kw["poses_init"] + nudge)
        return pairs, kw, falign_api.falign_pairs(**kw, device=device)
    pairs, kw, images = falign_lc_batch(np, torch, sc, seed=seed)
    if nudge:
        kw["poses_init"] = np.full((len(pairs), 2, 6), nudge, np.float32)
    geo = falign_api.falign_pairs(**kw, device=device)
    kw = dict(kw, images=images, poses_init=np.stack([r["poses_ret"] for r in geo]),
              coarse_stride=6, fine_iters=12)
    return pairs, kw, falign_api.falign_pairs(**kw, device=device)


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
    relative poses, the relative difference of their scale ratios, the
    largest difference of their visibility and consistency scores, and
    each run's rotation angle to the true relative pose (rad)."""
    out = []
    for (a, b), x, y in zip(pairs, card, cpu):
        truth = sc["Ts"][a] @ np.linalg.inv(sc["Ts"][b])
        Tx, Ty = _rel_poses(np, torch, x["poses_ret"]), _rel_poses(np, torch, y["poses_ret"])
        ra = x["scaling_factor"][1] / x["scaling_factor"][0]
        rb = y["scaling_factor"][1] / y["scaling_factor"][0]
        out.append(dict(
            scale=float(abs(ra / rb - 1.0)),
            score=max(float(np.nanmax(np.abs(x[k] - y[k]))) for k in ("visibility_mat", "consistency_mat")),
            pair=(a, b), iters=(x["iters_coarse"], x["iters"]), iters_cpu=(y["iters_coarse"], y["iters"]),
            iters_off=max(abs(x["iters_coarse"] - y["iters_coarse"]), abs(x["iters"] - y["iters"])),
            rot=_angle(np, Tx[:3, :3], Ty[:3, :3]), trans=float(np.abs(Tx[:3, 3] - Ty[:3, 3]).max()),
            truth_rot=_angle(np, Tx[:3, :3], truth[:3, :3]),
            truth_rot_cpu=_angle(np, Ty[:3, :3], truth[:3, :3])))
    return out


def phase_falign(np, torch, sc):
    """falign_pairs on the card against the same function on the CPU, four
    pairs, without and with images, and the loop-closure batch: per lane,
    the iterations, the relative rotation and translation within
    FALIGN_LIMITS of their kind, the card's rotation no farther from the
    true one than the CPU's by more than the kind's limit; the scale
    ratio and the scores within the kind's limits, every
    solver tensor on the card, and the covariances the card computed
    against pair_covariances on the CPU at the card's parameters within
    FALIGN_COV_RTOL."""
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.falign import solver as fsolver
    from voldor_tpu_torch.ops.image import bilinear_sample, bilinear_sample_packed_grad

    # a NaN coordinate (a point on the camera plane) on the card: NaN samples
    # from in-range indices (a NaN's own cast is out of range: the gather's
    # device-side assert)
    img = torch.rand(6, 7, 3, device="cuda")
    x = torch.tensor([1.5, float("nan")], device="cuda")
    y = torch.tensor([2.0, 1.0], device="cuda")
    packed = bilinear_sample_packed_grad(img[None], x[None], y[None])[0][0]
    plain = bilinear_sample(img[..., 0], x, y)
    torch.cuda.synchronize()
    log(f"[falign] sampling at a NaN coordinate on the card: packed {packed.tolist()}, plain "
        f"{plain.tolist()}")
    if not (bool(torch.isnan(packed[1]).all()) and bool(torch.isfinite(packed[0]).all())
            and bool(torch.isnan(plain[1])) and bool(torch.isfinite(plain[0]))):
        raise AssertionError("bilinear sampling at a NaN coordinate is not NaN on the card")

    real_iterate = fsolver.lm_iterate
    off_card = []

    def checked_iterate(prob, st, lanes, stride, *a, **k):
        out = real_iterate(prob, st, lanes, stride, *a, **k)
        for name, t in (list(prob.maps._asdict().items()) + list(st._asdict().items())
                        + [("out." + n, v) for n, v in out._asdict().items()]):
            if t.device.type != "cuda":
                off_card.append(name)
        return out

    worst = dict(scale=0.0, score=0.0, cov=0.0)
    failed = []
    cov_failed = []
    for kind in ("geo", "photo", "lc"):
        solved = []
        fsolver.lm_iterate = checked_iterate
        try:
            with spying(falign_api, "solve_lanes", solved):
                pairs, kw, card = falign_run(np, torch, sc, kind, "cuda")
        finally:
            fsolver.lm_iterate = real_iterate
        _, _, cpu = falign_run(np, torch, sc, kind, "cpu")
        if off_card:
            raise AssertionError(f"falign solver tensors off the card: {sorted(set(off_card))}")
        lanes = falign_lanes(np, torch, sc, pairs, card, cpu)
        scale = max(ln["scale"] for ln in lanes)
        score = max(ln["score"] for ln in lanes)
        worst["scale"], worst["score"] = max(worst["scale"], scale), max(worst["score"], score)
        # the covariance function on the CPU at the card's parameters
        cov_card = np.stack([a["poses_covar"] for a in card])
        cov_ref = cpu_covariances(np, torch, kw, solved[-1][0].cpu().numpy())
        denom = np.maximum(np.abs(cov_ref), 1e-12)
        diag = np.arange(7)
        cov_err = float((np.abs(cov_card - cov_ref)[..., diag, diag] / denom[..., diag, diag]).max())
        worst["cov"] = max(worst["cov"], cov_err)
        if cov_err > FALIGN_COV_RTOL:
            cov_failed.append(kind)
        cov_indep = float((np.abs(cov_card - np.stack([b["poses_covar"] for b in cpu]))
                           [..., diag, diag] / denom[..., diag, diag]).max())
        lim = FALIGN_LIMITS[kind]
        for ln in lanes:
            log(f"[falign] {kind} lane {ln['pair']}: iterations (coarse, fine) card {ln['iters']} cpu "
                f"{ln['iters_cpu']} (limit {lim['iters'] or 'none'}); rotation {ln['rot']:.3e} rad "
                f"(limit {lim['rot']:.1e}), translation {ln['trans']:.3e} (limit {lim['trans']:.1e}); "
                f"rotation to the true pose card {ln['truth_rot']:.3e} cpu {ln['truth_rot_cpu']:.3e} "
                f"(limit cpu + {lim['truth']:.1e})")
            iters_out = lim["iters"] is not None and ln["iters_off"] > lim["iters"]
            if iters_out or ln["rot"] > lim["rot"] or ln["trans"] > lim["trans"]:
                failed.append((kind, ln["pair"], "card vs cpu"))
            if ln["truth_rot"] > ln["truth_rot_cpu"] + lim["truth"]:
                failed.append((kind, ln["pair"], "rotation to the true pose"))
            if ln["scale"] > lim["scale"] or ln["score"] > lim["score"]:
                failed.append((kind, ln["pair"], "scale ratio or scores"))
        log(f"[falign] {kind}: scale ratio {scale:.3e} (limit {lim['scale']:.1e}), scores "
            f"{score:.3e} (limit {lim['score']:.1e}); "
            f"covariance diagonals vs the CPU at the card's parameters {cov_err:.3e} relative "
            f"(vs the CPU's own solve {cov_indep:.3e}); consistency "
            f"{[round(float(np.nanmean(a['consistency_mat'])), 4) for a in card]}")
    if failed:
        raise AssertionError(f"falign lanes on the card outside their limits: {failed}")
    if cov_failed:
        raise AssertionError(f"falign covariances on the card disagree with the CPU's: {cov_failed}")
    return worst


# --------------------------------------------------------------------------
# phase 12, second half: the falign kernels against their plain versions
# --------------------------------------------------------------------------

# The CPU tests' tolerances (tests/test_torch_falign.py, module docstring):
# Jacobian-derived blocks within 1e-4 of the block's largest entry (per pair
# evaluation; the cost relative to itself), one LM step within 2e-3 of its
# largest entry, the next state's H and g, at the same trial, within the
# blocks' 1e-4; visible-pixel counts equal.
FALIGN_BLOCK_RTOL = 1e-4
FALIGN_STEP_RTOL = 2e-3
FALIGN_STRIDES = (3, 4, 6)
# The linearise kernel's least work per pixel, counted from the plain
# formula (residual.py:pair_residual_and_grads): the grid coordinates (2
# sub, 2 div), the points in the ref and tar cameras (34), the projection
# and its tests (17, div), the sampled taps with their derivatives (16 +
# 5 x 21), the geometric term and its tests (38, 2 div), the weights and
# the photometric term (14, div), the robustifier (5, log, sqrt), the
# reverse pass (30 + 3 x 41, 3 div), the pose, scale and colour columns
# (95) and the masks (18): ~495 FP32 instructions, 9 divisions, a square
# root and a log; then the 190 products of the Gram matrix, one FMA each.
FALIGN_PX = least_ops(495, div=9, sqrt=1, log=1)
FALIGN_GRAM = least_ops(190)
# scores mode (residual.py:pair_residual_map, per pixel): the back-projection
# (2 sub, 2 div, 3), two rotations by rvec (2 x 24) and their offsets (6),
# the projection and its tests (17, 2 div), the taps (16 + 5 x 7), the
# geometric term (30, 2 div), the photometric term (7), the robustifier (5,
# log, sqrt) and the score (5, div)
FALIGN_SCORE_PX = least_ops(170, div=7, sqrt=1, log=1)


def falign_kernel_inputs(np, torch, sc, kind):
    """(prob, params, lanes) of phase 12's batch of a kind on the card: its
    maps (the lc batch with its stage-2 images), the init poses, and
    seeded depth-scale, colour-scale and colour-offset parameters, so that
    every Jacobian column is exercised."""
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.falign.residual import precompute_maps

    if kind == "lc":
        pairs, kw, images = falign_lc_batch(np, torch, sc)
        kw = dict(kw, images=images)
        init = np.zeros((len(pairs), 2, 6), np.float32)
    else:
        pairs, kw = falign_batch(np, torch, sc, 4, kind == "photo")
        init = kw["poses_init"]
    P = len(pairs)
    dev = torch.device("cuda")
    shape = (P * 2, H, W)
    maps = precompute_maps(falign_api._tensor(kw["depths"], dev, shape),
                           falign_api._tensor(kw["weights"], dev, shape),
                           falign_api._tensor(kw.get("images"), dev, shape),
                           kw["fx"], kw["fy"], kw["cx"], kw["cy"])
    photo = "images" in kw
    gauge = np.zeros((1, 18), np.float32)
    gauge[0, 6] = gauge[0, 15] = 1.0
    prob = falign_api._problem(maps, ((0, 1), (1, 0)), 2, kw["fx"], kw["fy"], kw["cx"], kw["cy"],
                               kw["vbf"], kw["crw"], photo, falign_api._dim_mask(2, True, photo),
                               gauge, dev)
    params = np.zeros((P, 2, 9), np.float32)
    params[:, :, :6] = init
    params[:, :, 6:] = np.random.default_rng(300).normal(0, [0.01, 0.02, 0.5], (P, 2, 3))
    return prob, torch.as_tensor(params, device=dev), torch.arange(P, device=dev)


def plain_blocks(prob, params, lanes, stride):
    from voldor_tpu_torch.falign.residual import pair_normal_blocks

    return pair_normal_blocks(params, lanes, prob.pairs, prob.dim_mask, prob.maps, *prob.intr,
                              prob.vbf, prob.crw, prob.use_photo, stride)


def rel_err(a, b):
    """Largest |a - b| over each leading-axis slice, relative to that slice's
    largest |b|; the largest over the slices."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    scale = b.abs().amax(dim=1).clamp_min(1e-30)
    return float(((a - b).abs().amax(dim=1) / scale).max())


def block_errs(kern, plain):
    return {name: rel_err(getattr(kern, name), getattr(plain, name)) for name in plain._fields}


def expect_refused(exc, fn, what):
    try:
        fn()
    except exc as e:
        log(f"[falign-kernels] {what}: refused ({type(e).__name__}: {e})")
        return
    raise AssertionError(f"falign kernels: {what} was not refused")


def damped_system(torch, prob, st, dtype):
    """Every lane's damped, gauge-regularised system from st, as
    lm_propose_reference builds it, in dtype: (A (L, D, D), b (L, D))."""
    L = st.params.shape[0]
    U, mask = prob.gauge_U.to(dtype), prob.dim_mask.to(dtype)
    H, g, p = st.H.to(dtype), st.g.to(dtype), st.params.to(dtype).reshape(L, -1)
    w2 = torch.where(st.w2 > 0, st.w2.to(dtype),
                     torch.sum(torch.diagonal(H, dim1=-2, dim2=-1) * torch.sum(U, dim=0), dim=-1)
                     / torch.clamp_min(torch.sum(U), 1.0))
    Hg = H + w2[:, None, None] * (U.T @ U)
    gg = g + w2[:, None] * ((p @ U.T) @ U)
    diag = torch.clamp_min(torch.diagonal(Hg, dim1=-2, dim2=-1), 1e-8)
    return Hg + torch.diag_embed(st.lam.to(dtype)[:, None] * diag + (1.0 - mask).reshape(-1)), gg


def solve_damped(torch, prob, st, dtype):
    """Every lane's step from st: damped_system solved the way
    lm_propose_reference solves it (cholesky_ex, the identity where the
    factor fails, two triangular solves), in dtype. Returns (the masked
    step (L, N, 9), whether the factor succeeded (L,))."""
    L, N = st.params.shape[0], prob.n_frames
    A, b = damped_system(torch, prob, st, dtype)
    Lc, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(Lc).all(dim=(-2, -1))
    Lc = torch.where(ok[:, None, None], Lc, torch.eye(9 * N, dtype=dtype, device=Lc.device))
    half = torch.linalg.solve_triangular(Lc, b[..., None], upper=False)
    step = torch.linalg.solve_triangular(Lc.transpose(-1, -2), half, upper=True)[..., 0]
    return step.reshape(L, N, 9) * prob.dim_mask.to(dtype), ok


def backward_error(A, b, x):
    """Per lane, the normwise backward error of x as a solution of A x = b,
    in float64: |b - A x| / (|A| |x| + |b|), infinity norms."""
    A, b, x = A.double(), b.double(), x.double().reshape(b.shape)
    r = b - (A @ x[..., None])[..., 0]
    den = A.abs().sum(dim=2).amax(dim=1) * x.abs().amax(dim=1) + b.abs().amax(dim=1)
    return r.abs().amax(dim=1) / den.clamp_min(1e-300)


def kernel_iteration(torch, prob, st, lanes, stride):
    """One LM iteration by the chunk kernel (lm_chunk with n = 1), launched
    once more through its C entry point with the step output (the same
    launch: the same state, bitwise). Returns (the state, each lane's
    masked step (L, N, 9), NaN where the lane did not run)."""
    from voldor_tpu_torch.ops import falign_kernels as fk

    out, (fn, args) = captured_call(lambda: fk.lm_chunk(prob, st, lanes, stride, 1),
                                    "falign_lm_chunk_launch")
    L, N = st.params.shape[:2]
    step = torch.full(st.params.shape, math.nan, device=st.params.device)
    # the wrapper's work buffer (D > 32) went with its call: a live one
    work = torch.empty((L, 9 * N, 9 * N), device=st.params.device) if 9 * N > 32 else None
    checked(fn(*args[:-5], None if work is None else work.data_ptr(), step.data_ptr(),
               *args[-3:]), "chunk with its step")
    return out, step


# Every step the kernel takes is held to the float32 system it solved by its
# backward error, measured in float64 (backward_error): at most D u, u =
# 2^-24, the classical bound of a Cholesky solve of a D x D system. A fault
# in the factor or the solves leaves a residual of the order of the step;
# conditioning does not move the backward error. It moves the forward
# error: on the geo batch's systems (condition numbers ~3e8) two float32
# solves, the kernel's and torch's, each lie up to ~10x further from the
# float64 solve than the other, lane by lane; both distances are printed.
# Where the float32 factor fails, the kernel's step (the identity's) is
# held within FALIGN_STEP_RTOL of the float64 reference's.
FALIGN_ETA_U = 2.0 ** -24


def step_errs(torch, prob, lanes, stride, st, a, b, step_a, blocks=None):
    """One LM iteration from st, by the kernel (a, its step step_a) and by
    the plain iteration (b): iteration counts and done flags equal, the
    steps taken by the same lanes, and the kernel's state moved by its
    step; per lane the parameters' largest difference relative to the
    plain step's largest move; each lane's step against the float32
    system it solved, by its backward error in float64 (step_eta; over its
    bound, step_eta_excess, at most 1), and the kernel's and the plain
    float32 solve's distances from the float64 solve relative to its
    largest entry (step64_lanes: per lane the two distances, then the two
    backward errors); lam and w2
    relative to the plain step's; the carried cost, H and g against the
    plain linearisation at the kernel's own parameters (the state's normal
    equations are those at its params), relative to each lane's largest
    entry (or against `blocks`, a linearisation function other than the
    plain one)."""
    from voldor_tpu_torch.ops import falign_kernels as fk

    out = {k: bool(torch.equal(getattr(a, k), getattr(b, k))) for k in ("it", "done")}
    acc_k = (a.params != st.params).flatten(1).any(dim=1)
    acc_p = (b.params != st.params).flatten(1).any(dim=1)
    moved = bool(torch.equal(a.params[acc_k], (st.params - step_a)[acc_k]))
    out["it"] = out["it"] and bool(torch.equal(acc_k, acc_p)) and moved  # the same steps taken
    move = (b.params - st.params).abs().amax(dim=(1, 2)).clamp_min(1e-30)
    out["step"] = float(((a.params - b.params).abs().amax(dim=(1, 2)) / move).max())
    out["step_abs"] = float((a.params - b.params).abs().max())
    ran = ~st.done
    s64, _ = solve_damped(torch, prob, st, torch.float64)
    s32, ok = solve_damped(torch, prob, st, torch.float32)
    scale = s64.abs().amax(dim=(1, 2)).clamp_min(1e-30)
    dk = (step_a.double() - s64).abs().amax(dim=(1, 2)) / scale
    dp = (s32.double() - s64).abs().amax(dim=(1, 2)) / scale
    A, rhs = damped_system(torch, prob, st, torch.float32)
    ek, ep = backward_error(A, rhs, step_a), backward_error(A, rhs, s32)
    D = 9 * prob.n_frames
    excess = torch.where(ok, ek / (D * FALIGN_ETA_U), dk / FALIGN_STEP_RTOL)
    for k, v in (("step_eta", ek), ("step_eta_f32", ep), ("step_eta_excess", excess),
                 ("step64", dk), ("step64_f32", dp)):
        out[k] = float(v[ran].max()) if bool(ran.any()) else 0.0
    out["step64_lanes"] = [[float(f"{v:.3e}") for v in vals] for vals in zip(
        *(t[ran].tolist() for t in (dk, dp, ek, ep)))]
    for k in ("lam", "w2"):
        out[k] = rel_err(getattr(a, k)[:, None], getattr(b, k)[:, None])
    # a lane that took its step carries the linearisation at its new
    # parameters; one that did not keeps its state bitwise
    cost, Hp, gp = fk.assemble((blocks or plain_blocks)(prob, a.params, lanes, stride),
                               prob.oh_r, prob.oh_t)
    for k, ref in (("cost", cost), ("H", Hp), ("g", gp)):
        got, old = getattr(a, k), getattr(st, k)
        if k == "cost":
            got, old, ref = got[:, None], old[:, None], ref[:, None]
        kept = bool(torch.equal(got[~acc_k], old[~acc_k]))
        out[k] = (rel_err(got[acc_k], ref[acc_k]) if bool(acc_k.any()) else 0.0) if kept else math.inf
    return out


# An LM chunk is held to its plain version iteration by iteration, from the
# kernel's own state. Its first two iterations (lam 1e-3 and below it once)
# in full, as one step and a second were held before: the step within
# FALIGN_STEP_RTOL, lam, w2, and the carried cost, H and g against the plain
# linearisation at the kernel's parameters within FALIGN_BLOCK_RTOL. Every
# iteration's step held to its system in float64 (FALIGN_ETA_U), its flags
# (it, done, the step taken) equal to the plain version's, and its carried cost, H and g
# within FALIGN_BLOCK_RTOL of the plain linearisation's (the first two) or
# of the one-shot linearise kernel's (held to the plain version above) at
# its parameters. Later iterations solve ever less damped systems (lam
# falls by up to 3x an accepted step towards 1e-7), whose steps any two
# float32 factorisation orders give apart by far more than the rounding,
# and approach the optimum, where g is a sum that cancels to far below its
# terms, and many residuals near the sqrt-Cauchy branch at r^2 =
# FLT_EPSILON, where a last bit moves a pixel's Jacobian; their step, lam
# and state readings against the plain float32 version are printed.
FALIGN_FULL_STEPS = 2


def chunk_case(np, torch, prob, st, lanes, stride, n, what):
    """n LM iterations from st through the chunk kernel, held iteration by
    iteration: the kernel's chunk of n is bitwise its n chunks of one, and
    each of those against the plain iteration from the same state
    (step_errs; the first FALIGN_FULL_STEPS in full). Returns (the worst
    readings, the kernel's state); raises where they disagree beyond the
    tolerances."""
    from voldor_tpu_torch.ops import falign_kernels as fk

    whole = fk.lm_chunk(prob, st, lanes, stride, n)
    cur, worst, late, accepted, by_iter = st, {}, {}, [], []
    for k in range(n):
        sk, step_k = kernel_iteration(torch, prob, cur, lanes, stride)
        sp = fk.lm_step_reference(prob, cur, lanes, stride, cur.it + 1)
        rec = step_errs(torch, prob, lanes, stride, cur, sk, sp, step_k)
        by_iter.append(rec.pop("step64_lanes"))
        if k >= FALIGN_FULL_STEPS:
            kern = step_errs(torch, prob, lanes, stride, cur, sk, sp, step_k, blocks=fk.linearize)
            late_keys = ("step", "step_abs", "lam", "cost", "H", "g")
            for key in late_keys:
                late[key] = max(late.get(key, 0.0), rec[key])
            rec = {key: kern[key] if key in ("cost", "H", "g") else v for key, v in rec.items()
                   if key not in ("step", "step_abs", "lam")}
        for key, v in rec.items():
            worst[key] = (worst.get(key, True) and v) if isinstance(v, bool) else max(worst.get(key, 0.0), v)
        accepted.append((sk.params != cur.params).flatten(1).any(dim=1).int().tolist())
        cur = sk
    worst["chunk_is_its_steps"] = all(bool(torch.equal(x, y)) for x, y in zip(whole, cur))
    worst["it"] = worst["it"] and worst["chunk_is_its_steps"]
    worst["iterations"] = cur.it.tolist()
    worst["accepted"] = accepted
    worst["late"] = late
    # per iteration, per lane: the distances from the float64 step (kernel,
    # plain float32), then the backward errors (kernel, plain float32)
    worst["step64_by_iter"] = by_iter
    bad = (not (worst["it"] and worst["done"]) or worst["step"] > FALIGN_STEP_RTOL
           or worst["step_eta_excess"] > 1.0
           or max(worst[k] for k in ("lam", "cost", "w2", "H", "g")) > FALIGN_BLOCK_RTOL)
    log(f"[falign-kernels] LM {what}: {json.dumps(worst)}")
    if bad:
        raise AssertionError(f"falign LM chunk kernel disagrees with its plain version: {what}")
    return worst, whole


def keyframe_lane(np, torch, sc, frames, dof7=True):
    """One falign() lane of the full-SLAM scene's frames `frames`, fully
    connected (N (N - 1) pairs, D = 9 N), at falign_batch's settings (1%
    seeded depth noise blurred at width 3, gray images blurred at width 5,
    seeded confidences, photometric), 7-dof with falign()'s one scale-gauge
    row, or 6-dof without gauge rows; the true poses relative to the first
    frame with a small seeded error, and seeded depth-scale and colour
    parameters. Returns (prob, params (1, N, 9), lanes)."""
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.falign.residual import precompute_maps
    from voldor_tpu_torch.ops.image import gaussian_blur
    from voldor_tpu_torch.slam.slam_utils import T44_to_T6

    rng = np.random.default_rng(400)
    n = len(frames)

    def blur(a, k):
        return gaussian_blur(torch.from_numpy(np.ascontiguousarray(a, np.float32)), k).numpy()

    D = np.stack([blur(sc["depths"][f] * (1.0 + 0.01 * rng.standard_normal((H, W))), 3)
                  for f in frames])
    I = np.stack([blur(sc["images_grayf"][f], 5) for f in frames])
    Wt = rng.uniform(0.5, 1.0, D.shape).astype(np.float32)
    dev = torch.device("cuda")
    maps = precompute_maps(*(falign_api._tensor(a, dev) for a in (D, Wt, I)), FX, FY, W / 2, H / 2)
    pairs = [(r, t) for r in range(n) for t in range(n) if r != t]
    gauge = np.zeros((1 if dof7 else 0, 9 * n), np.float32)
    gauge[:, 6::9] = 1.0
    prob = falign_api._problem(maps, pairs, n, FX, FY, W / 2, H / 2, BASEFOCAL * 5, 10.0, True,
                               falign_api._dim_mask(n, dof7, True), gauge, dev)
    params = np.zeros((1, n, 9), np.float32)
    for k, f in enumerate(frames[1:], 1):
        rel = sc["Ts"][frames[0]] @ np.linalg.inv(sc["Ts"][f])  # cam f -> the first camera
        params[0, k, :6] = T44_to_T6(rel.astype(np.float32)) + rng.normal(0, [2e-3] * 3 + [1e-2] * 3)
    params[0, :, 6:] = rng.normal(0, [0.01, 0.02, 0.5], (n, 3))
    params[0, :, 6] *= float(dof7)  # 6-dof: the scale stays 0
    return prob, torch.as_tensor(params, device=dev), torch.zeros(1, dtype=torch.int64, device=dev)


# falign() lanes of phase 12: (frames, 7-dof, chunk length, what they cover)
KEYFRAME_LANES = (
    ((0, 5, 10), False, 4, "three frames, 6-dof, no gauge rows (D = 27, the warp factor)"),
    ((0, 5, 10, 15), True, 4, "four frames (D = 36, the block-wide factor)"),
    (tuple(range(20)), True, 3, "twenty frames (D = 180, 380 pairs in 24 groups)"),
)


def phase_falign_kernels(np, torch, sc):
    """The linearise kernel (both modes) and the LM chunk kernel against
    their plain versions on the card, on phase 12's geo, photo and
    loop-closure batches at strides 3, 4 and 6: one step, a second, a chunk
    of 8; rejected steps, a failed Cholesky factor and frozen lanes; a lane
    of four frames (the block-wide factor); two launches on the same inputs
    bitwise equal, a chunk of 8 bitwise equal to eight chunks of one; a
    chunk under set_sync_debug_mode("error"); wrong inputs refused."""
    from voldor_tpu_torch.falign import solver as fsolver
    from voldor_tpu_torch.falign.residual import pair_score_sums
    from voldor_tpu_torch.ops import falign_kernels as fk

    worst = dict(blocks=0.0, blocks_abs=0.0, cons=0.0, step=0.0, step_abs=0.0, state=0.0)

    def note(rec):
        worst["step"] = max(worst["step"], rec["step"])
        worst["step_abs"] = max(worst["step_abs"], rec["step_abs"])
        worst["state"] = max([worst["state"]] + [rec[k] for k in ("lam", "cost", "w2", "H", "g")])
        return rec

    for kind in ("geo", "photo", "lc"):
        prob, params, lanes = falign_kernel_inputs(np, torch, sc, kind)
        for stride in FALIGN_STRIDES:
            kern = fk.linearize(prob, params, lanes, stride)
            plain = plain_blocks(prob, params, lanes, stride)
            errs = block_errs(kern, plain)
            p1 = fk.linearize_packed(prob, params, lanes, stride)
            p2 = fk.linearize_packed(prob, params, lanes, stride)
            nk, ck = fk.score_sums(prob, params, lanes, stride, 1.0)
            npl, cpl = pair_score_sums(params, lanes, prob.pairs, prob.maps, *prob.intr, prob.vbf,
                                       prob.crw, prob.use_photo, stride,
                                       torch.tensor(1.0, device="cuda"))
            s1 = fk.linearize_packed(prob, params, lanes, stride, scores=True)
            s2 = fk.linearize_packed(prob, params, lanes, stride, scores=True)
            torch.cuda.synchronize()
            cons = rel_err(ck[:, None], cpl[:, None])
            same_vis = bool(torch.equal(nk, npl))
            bitwise = bool(torch.equal(p1, p2) and torch.equal(s1, s2))
            worst["blocks"] = max(worst["blocks"], max(errs.values()))
            worst["blocks_abs"] = max([worst["blocks_abs"]] + [
                float((getattr(kern, k) - getattr(plain, k)).abs().max()) for k in plain._fields])
            worst["cons"] = max(worst["cons"], cons)
            log(f"[falign-kernels] {kind} stride {stride}: blocks vs plain (relative to each "
                f"block's largest entry) {json.dumps(errs)}; visible pixels kernel "
                f"{nk.long().tolist()} plain {npl.long().tolist()}; consistency sums {cons:.3e}; "
                f"two launches bitwise equal {bitwise}")
            if not same_vis:
                raise AssertionError(f"falign scores: visible pixels differ ({kind}, stride {stride})"
                                     f": kernel {nk.tolist()} plain {npl.tolist()}")
            if max(errs.values()) > FALIGN_BLOCK_RTOL or cons > FALIGN_BLOCK_RTOL or not bitwise:
                raise AssertionError(f"falign linearise kernel disagrees ({kind}, stride {stride})")
            st = fsolver.phase_init(prob, params, lanes, stride)
            note(chunk_case(np, torch, prob, st, lanes, stride, 8,
                            f"{kind} stride {stride}, a chunk of 8")[0])
        st = fsolver.phase_init(prob, params, lanes, 4)
        # every step rejected: the carried cost below any trial's
        note(chunk_case(np, torch, prob, st._replace(cost=torch.zeros_like(st.cost)), lanes, 4, 1,
                        f"{kind}, rejected steps")[0])
        # a failed Cholesky factor: the identity, ok false, the step rejected
        eye = torch.eye(18, device="cuda").expand_as(st.H)
        st_f = st._replace(H=(-1e6 * eye).contiguous(), g=torch.zeros_like(st.g))
        _, out_f = chunk_case(np, torch, prob, st_f, lanes, 4, 1, f"{kind}, failed factor")
        if not (torch.equal(out_f.params, st_f.params) and torch.equal(out_f.lam, 4.0 * st_f.lam)):
            raise AssertionError("falign LM: a negative definite system was not rejected")
        # frozen lanes: done (the even ones), or all out of budget
        st_d = st._replace(done=lanes % 2 == 0)
        frozen = fk.lm_iteration(prob, st_d, lanes, 4, st.it + 1)
        if not all(torch.equal(x[0::2], y[0::2]) for x, y in zip(frozen, st_d)):
            raise AssertionError("falign LM: a lane that was done changed")
        if not all(torch.equal(x, y) for x, y in zip(fk.lm_iteration(prob, st, lanes, 4, st.it), st)):
            raise AssertionError("falign LM: lanes out of budget changed")
        # a chunk of 8 against eight chunks of one, the done lanes included
        whole = fk.lm_chunk(prob, st_d, lanes, 4, 8)
        ones = st_d
        for _ in range(8):
            ones = fk.lm_chunk(prob, ones, lanes, 4, 1)
        if not all(torch.equal(x, y) for x, y in zip(whole, ones)):
            raise AssertionError(f"falign LM: a chunk of 8 differs from eight chunks of one ({kind})")
        log(f"[falign-kernels] {kind}: a chunk of 8 bitwise equal to eight chunks of one "
            f"(iterations {whole.it.tolist()}, done lanes frozen)")
    # falign() lanes: the warp factor without gauge rows, the block-wide one
    for frames, dof7, n_it, what in KEYFRAME_LANES:
        probk, paramsk, lanesk = keyframe_lane(np, torch, sc, frames, dof7)
        n_p = probk.pairs.shape[0]
        errs = block_errs(fk.linearize(probk, paramsk, lanesk, 4),
                          plain_blocks(probk, paramsk, lanesk, 4))
        log(f"[falign-kernels] a lane of {what}, {n_p} pairs, stride 4: blocks vs plain "
            f"{json.dumps(errs)}; shared memory per block "
            f"{fk.lm_smem_bytes(len(frames), probk.gauge_U.shape[0], n_p)} B")
        if max(errs.values()) > FALIGN_BLOCK_RTOL:
            raise AssertionError(f"falign linearise kernel disagrees on a lane of {what}")
        stk = fsolver.phase_init(probk, paramsk, lanesk, 4)
        note(chunk_case(np, torch, probk, stk, lanesk, 4, n_it,
                        f"a lane of {what}, a chunk of {n_it}")[0])
    prob, params, lanes = falign_kernel_inputs(np, torch, sc, "photo")
    # reproducible run to run: one whole chunk twice
    st = fsolver.phase_init(prob, params, lanes, 4)
    a = fsolver.lm_iterate(prob, st, lanes, 4, 8)
    b = fsolver.lm_iterate(prob, st, lanes, 4, 8)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("falign LM: two runs of one chunk differ")
    torch.cuda.set_sync_debug_mode("error")
    try:
        fsolver.lm_iterate(prob, st, lanes, 4, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[falign-kernels] a chunk of 8 LM iterations twice: bitwise equal; under "
        f"set_sync_debug_mode('error'): no host sync; iterations per lane {a.it.tolist()}")
    # refusals
    cpu_maps = prob.maps._replace(packed=prob.maps.packed.cpu(), weights=prob.maps.weights.cpu())
    expect_refused(ValueError, lambda: fk.linearize_packed(prob, params.cpu(), lanes, 4),
                   "params on the CPU")
    expect_refused(ValueError, lambda: fk.linearize_packed(
        prob, params[..., :8].contiguous(), lanes, 4), "params of a wrong shape")
    expect_refused(ValueError, lambda: fk.lm_chunk(prob._replace(maps=cpu_maps), st, lanes, 4, 8),
                   "maps on the CPU")
    expect_refused(TypeError, lambda: fk.lm_chunk(prob, st._replace(it=st.it.long()), lanes, 4, 8),
                   "an int64 iteration count")
    expect_refused(RuntimeError, lambda: fk._check_lm_fits(params.device, 40, 1, 40 * 39),
                   "a 40-frame lane (360 parameters)")
    fk._check_lm_fits(params.device, 26, 1, 26 * 25)  # the largest lane that fits
    _, (fn, args) = captured_call(lambda: fk.lm_chunk(prob, st, lanes, 4, 1),
                                  "falign_lm_chunk_launch")
    rc = fn(*args[:-2], 32, args[-1])
    if rc == 0:
        raise AssertionError("falign kernels: a cluster of 32 blocks was not refused")
    log(f"[falign-kernels] a cluster of 32 blocks: refused by the chunk kernel's C entry point "
        f"(cudaError {rc})")
    log(f"[falign-kernels] chunk kernel shared memory per block: a 2-frame lane "
        f"{fk.lm_smem_bytes(2, 1, 2)} B, a 26-frame lane {fk.lm_smem_bytes(26, 1, 650)} B; "
        f"largest error {json.dumps(worst)}")
    return worst


def captured_call(call, name):
    """Run a wrapper call, recording the C entry point `name` and the
    arguments of its launch. Returns (the call's result, (fn, args))."""
    from voldor_tpu_torch.ops import _build

    real = _build.function
    seen = []

    def spy(fname, argtypes):
        fn = real(fname, argtypes)

        def rec(*a):
            if fname == name:
                seen.append((fn, a))
            return fn(*a)
        return rec

    _build.function = spy
    try:
        out = call()
    finally:
        _build.function = real
    if len(seen) != 1:
        raise AssertionError(f"{name}: {len(seen)} launches recorded, expected 1")
    return out, seen[0]


def falign_least_bytes(np, torch, prob, params, lanes, stride):
    """The linearise kernel's least bytes at these inputs: the 32-byte
    sectors of the ref-side reads (depth, image when photometric, weight
    at the strided grid), and of the tar-side taps (two rows of two
    packed pixels) of the pixels that project into the tar frame, each
    sector once; the parameters once; the per-pair blocks written once."""
    from voldor_tpu_torch.falign.residual import lane_pairs
    from voldor_tpu_torch.ops import falign_kernels as fk
    from voldor_tpu_torch.ops.lie import rotate_rvec

    F, h, w, _ = prob.maps.packed.shape
    fx, fy, cx, cy = prob.scalars[:4]
    pr, pt, ref, tar = lane_pairs(params, lanes, prob.pairs)
    ys = torch.arange(0, h, stride, device="cuda")
    xs = torch.arange(0, w, stride, device="cuda")
    px = (ys[:, None] * w + xs[None, :])[None] + (ref * h * w)[:, None, None]
    chans = [0, 4] if prob.use_photo else [0]
    sect = [torch.div(px * 20 + 4 * c, 32, rounding_mode="floor").flatten() for c in chans]
    packed = set(torch.unique(torch.cat(sect)).tolist())
    weights = torch.unique(torch.div(px * 4, 32, rounding_mode="floor")).numel()
    d = prob.maps.depths[:, ::stride, ::stride][ref] * torch.exp(pr[:, 6])[:, None, None]
    yy, xx = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
    p3r = torch.stack([((xx - cx) / fx) * d, ((yy - cy) / fy) * d, d], -1)
    p3w = rotate_rvec(p3r, pr[:, None, None, :3]) + pr[:, None, None, 3:6]
    r0 = -pt[:, :3]
    p3t = rotate_rvec(p3w, r0[:, None, None]) - rotate_rvec(pt[:, 3:6], r0)[:, None, None]
    z = p3t[..., 2]
    u = fx * p3t[..., 0] / z + cx
    v = fy * p3t[..., 1] / z + cy
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z >= 1.0)
    x0 = torch.clamp(torch.floor(u), 0, w - 2).long()
    y0 = torch.clamp(torch.floor(v), 0, h - 2).long()
    base = ((tar[:, None, None] * h + y0) * w + x0)[inside]
    for row in (0, w):
        start = (base + row) * 20
        for s in range(3):  # 40 bytes span at most 3 sectors
            sec = torch.div(start, 32, rounding_mode="floor") + s
            keep = sec * 32 < start + 40
            packed.update(torch.unique(sec[keep]).tolist())
    B = ref.numel()
    return 32 * (len(packed) + weights) + 4 * B * 18 + 4 * B * fk.N_GRAM


_PROBE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 6
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
# block 0's phases of a chunk iteration (csrc/falign_lm.cu: Phase)
CHUNK_PHASES = ("setup", "factor_solves", "step", "pair_consts", "barrier_a", "linearize",
                "barrier_b", "rank_reduce", "accept")
# the chain probe's pieces (csrc/falign_lm.cu:falign_chain_probe_kernel) and
# the repetitions each is timed over
CHAIN_PIECES = (("factor_solves", 2000), ("pair_consts", 2000), ("pixel", 5000),
                ("gram_tile", 5000), ("rank_reduce", 2000), ("cluster_barrier", 20000))


def falign_chain(torch, prob, params, stride, cluster):
    """The chunk kernel's chain floor for one LM iteration of a lane (two
    frames, two pairs), from falign_chain_probe_kernel: each piece repeated
    n times in one launch (CUDA events around it), per repetition. The
    floor adds the warp's factor and solves (D = 18), one pair's constants,
    one pixel's evaluation, the Gram sums of the tiles the busiest block
    takes (np x ceil(T / C) tiles of 512 pixels), block 0's rank-order sum
    of the C blocks' np x 190 sums, and two cluster barriers. Returns
    (floor us, {piece: us per repetition}, tiles of the busiest block)."""
    from voldor_tpu_torch.ops import _build
    from voldor_tpu_torch.ops import falign_kernels as fk

    fn = _build.function("falign_chain_probe_launch", _PROBE_ARGTYPES)
    F, h, w, _ = prob.maps.packed.shape
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n_p = prob.pairs.shape[0]
    p0 = params[0].contiguous()
    us = {}
    for which, (name, n) in enumerate(CHAIN_PIECES):
        C = cluster if which >= 4 else 1

        def launch(reps=n):
            checked(fn(prob.maps.packed.data_ptr(), prob.maps.weights.data_ptr(), h, w, stride,
                       int(bool(prob.use_photo)), *prob.scalars, p0.data_ptr(),
                       prob.pairs.data_ptr(), prob.dim_mask.data_ptr(), prob.n_frames, n_p, which,
                       reps, C, out.data_ptr(), stream), f"chain probe {name}")

        launch(10)
        us[name] = event_ms(torch, launch, 3) / n * 1e3
        if not math.isfinite(float(out)):
            raise AssertionError(f"falign chain probe {name} left {float(out)}")
    tiles = n_p * -(-fk.n_tiles(h, w, stride) // cluster)
    floor = (us["factor_solves"] + us["pair_consts"] + us["pixel"] + tiles * us["gram_tile"]
             + us["rank_reduce"] + 2 * us["cluster_barrier"])
    return floor, us, tiles


def falign_times(np, torch, sc):
    """Device-only times of the falign kernels at phase 14's 4-pair
    photometric batch (stride 4) and the loop-closure batch (stride 3):
    the one-shot linearise and scores launches (CUDA events over 100
    back-to-back launches of the bound C call), the LM chunk kernel over a
    chunk of 8 from the phase start with clusters of 8 and of 16 blocks
    (per launch and per batched iteration; block 0's phases of an
    iteration timed in the kernel), beside their plain versions
    (CUDA events around one call), their bytes and operations bounds, the
    chunk's chain floor (falign_chain), and two yardsticks the port never
    calls: one torch.bmm of the plain Jacobians' Gram matrices, and
    torch.linalg.cholesky_ex + torch.cholesky_solve on the lanes' damped
    (L, 18, 18) systems. Returns the records by batch."""
    from voldor_tpu_torch.falign import solver as fsolver
    from voldor_tpu_torch.falign.residual import pair_jacobians, pair_score_sums
    from voldor_tpu_torch.ops import falign_kernels as fk

    recs = {}
    for kind, stride in (("photo", 4), ("lc", 3)):
        prob, params, lanes = falign_kernel_inputs(np, torch, sc, kind)
        st = fsolver.phase_init(prob, params, lanes, stride)
        # each launch's outputs stay referenced (lin_out, ...) while its
        # recorded pointers are launched again below
        lin_out, lin = captured_call(lambda: fk.linearize_packed(prob, params, lanes, stride),
                                     "falign_linearize_launch")
        sco_out, sco = captured_call(lambda: fk.linearize_packed(
            prob, params, lanes, stride, scores=True), "falign_linearize_launch")
        ms, ms_by_cluster = {}, {}
        for name, (fn, args) in (("linearize", lin), ("scores", sco)):
            ms[name] = device_ms(torch, lambda: checked(fn(*args), name))
            for C in (8, 16):  # the same launch with clusters of C blocks
                args_c = args[:-2] + (C, args[-1])
                ms_by_cluster[f"{name}_{C}"] = device_ms(torch, lambda: checked(fn(*args_c), name))
        chunk = {}
        out, (fn, args) = captured_call(lambda: fk.lm_chunk(prob, st, lanes, stride, 8),
                                        "falign_lm_chunk_launch")
        for C in (8, 16):
            args_c = args[:-2] + (C, args[-1])  # the same launch with clusters of C blocks
            checked(fn(*args_c), f"chunk, cluster of {C}")
            iters = int((out.it - st.it).max())
            lane_iters = (out.it - st.it).tolist()
            launch_ms = device_ms(torch, lambda: checked(fn(*args_c), "chunk"))
            chunk[C] = dict(launch_ms=launch_ms, batched_iters=iters, ms=launch_ms / iters,
                            lane_iters=lane_iters)
            if C == fk.CLUSTER:
                # block 0's phases (falign_lm.cu: Phase), timed in the kernel
                prof = torch.zeros((params.shape[0], len(CHUNK_PHASES) + 1), dtype=torch.int64,
                                   device="cuda")
                checked(fn(*args_c[:-3], prof.data_ptr(), *args_c[-2:]), "timed chunk")
                per = (prof[:, :-1].double() / prof[:, -1:].double().clamp_min(1)).mean(0) * 1e-3
                chunk[C]["phases_us"] = dict(zip(CHUNK_PHASES, per.tolist()))
        del out
        L, D = params.shape[0], 18
        plain_chunk = event_ms(torch, lambda: fk.lm_chunk_reference(prob, st, lanes, stride, 8), 3)
        plain = dict(
            linearize=event_ms(torch, lambda: plain_blocks(prob, params, lanes, stride), 5),
            scores=event_ms(torch, lambda: pair_score_sums(
                params, lanes, prob.pairs, prob.maps, *prob.intr, prob.vbf, prob.crw,
                prob.use_photo, stride, torch.tensor(1.0, device="cuda")), 5),
            chunk_per_iter=plain_chunk / chunk[fk.CLUSTER]["batched_iters"])
        # the yardsticks
        res, Jr, Jt = pair_jacobians(params, lanes, prob.pairs, prob.dim_mask, prob.maps,
                                     *prob.intr, prob.vbf, prob.crw, prob.use_photo, stride)
        V = torch.cat([res[..., None], Jr, Jt], -1).reshape(-1, res.shape[-1], 19)
        Vt = V.transpose(1, 2).contiguous()
        bmm_ms = device_ms(torch, lambda: torch.bmm(Vt, V))
        prop = fk.lm_propose_reference(prob, st, st.it + 1)
        w2 = prop.info[:, 0]
        U = prob.gauge_U
        Hg = st.H + w2[:, None, None] * (U.T @ U)
        diag = torch.clamp_min(torch.diagonal(Hg, dim1=-2, dim2=-1), 1e-8)
        damped = Hg + torch.diag_embed(st.lam[:, None] * diag + (1.0 - prob.dim_mask).reshape(-1))
        rhs = st.g[..., None].contiguous()

        def chol():
            f, _ = torch.linalg.cholesky_ex(damped)
            return torch.cholesky_solve(rhs, f)

        chol_ms = device_ms(torch, chol, 20)
        # bounds
        B, T = L * prob.pairs.shape[0], fk.n_tiles(H, W, stride)
        hs, ws = fk.grid_size(H, W, stride)
        n_px = B * hs * ws
        fp32, sfu = ops_ms({"px": n_px, "gram": n_px}, {"px": FALIGN_PX, "gram": FALIGN_GRAM})
        by = falign_least_bytes(np, torch, prob, params, lanes, stride) / HBM_BYTES_PER_S * 1e3
        lin_bound = max(by, fp32, sfu)
        s_fp32, s_sfu = ops_ms({"px": n_px}, {"px": FALIGN_SCORE_PX})
        # the chunk, per batched iteration: the maps' sectors and the state
        # (read once and written once a launch) spread over its iterations;
        # per iteration the linearisation's operations, the factor (D^3 / 6
        # FMAs, D square roots, D^2 / 2 divisions), the solves (D^2) and the
        # assembly's adds per lane
        its = chunk[fk.CLUSTER]["batched_iters"]
        state_b = 4 * L * (D * D + D + 9 * 2 + 5)
        lm_fp32, lm_sfu = ops_ms({"l": L}, {"l": least_ops(D ** 3 // 6 + D * D + B // L * 190,
                                                           div=D * D // 2 + 2 * D, sqrt=D)})
        ch_bytes_ms = (by + 2 * state_b / HBM_BYTES_PER_S * 1e3) / its
        ch_ops_ms = max(fp32 + lm_fp32, sfu + lm_sfu)
        floors = {C: falign_chain(torch, prob, params, stride, C) for C in (8, 16)}
        floor_us, pieces, tiles = floors[fk.CLUSTER]
        # the bound of the kernels line (bytes or operations); the chain
        # floor beside it, and which of the three binds
        ch_bound = max(ch_bytes_ms, ch_ops_ms)
        bound_by = "bytes" if ch_bytes_ms >= ch_ops_ms else "operations"
        binds = "the chain floor" if floor_us * 1e-3 >= ch_bound else bound_by
        recs[kind] = dict(stride=stride, pair_evals=B, tiles=T, ms=ms, ms_by_cluster=ms_by_cluster,
                          chunk=chunk, plain_ms=plain,
                          bmm_gram_ms=bmm_ms, cholesky_ms=chol_ms, linearize_bound_ms=lin_bound,
                          linearize_bound_by="bytes" if by >= max(fp32, sfu) else "operations",
                          linearize_bytes_ms=by, linearize_ops_ms=max(fp32, sfu),
                          scores_bound_ms=max(s_fp32, s_sfu), lm_bound_ms=ch_bound,
                          lm_bound_by=bound_by, lm_binds=binds, lm_bytes_ms=ch_bytes_ms,
                          lm_ops_ms=ch_ops_ms,
                          cluster=fk.CLUSTER, chain_floor_us=floor_us, chain_pieces_us=pieces,
                          chain_tiles=tiles,
                          chain_floor_by_cluster_us={C: f[0] for C, f in floors.items()})
        log(f"[times] falign kernels, {kind} batch (stride {stride}, {B} pair evaluations x "
            f"{hs}x{ws} pixels, {T} tiles of {fk.THREADS}): one-shot device ms per launch "
            f"({N_LAUNCH} launches) {json.dumps({k: round(v, 5) for k, v in ms.items()})} (by "
            f"cluster size {json.dumps({k: round(v, 5) for k, v in ms_by_cluster.items()})}); LM "
            f"chunk of 8 (lane iterations {chunk[8]['lane_iters']}): cluster of 8 "
            f"{chunk[8]['launch_ms']:.5f} ms a launch, {chunk[8]['ms'] * 1e3:.3f} us per batched "
            f"iteration; cluster of 16 {chunk[16]['launch_ms']:.5f} ms, "
            f"{chunk[16]['ms'] * 1e3:.3f} us; block 0's phases of an iteration at the default "
            f"cluster, us (timed in the kernel): "
            f"{json.dumps({k: round(v, 3) for k, v in chunk[fk.CLUSTER]['phases_us'].items()})}; "
            f"plain versions ms "
            f"{json.dumps({k: round(v, 4) for k, v in plain.items()})}; linearise bound "
            f"{lin_bound * 1e3:.3f} us (bytes {by * 1e3:.3f} us, FP32 {fp32 * 1e3:.3f} us, "
            f"special-function {sfu * 1e3:.3f} us); scores bound "
            f"{max(s_fp32, s_sfu) * 1e3:.3f} us; chunk per iteration: bytes "
            f"{ch_bytes_ms * 1e3:.4f} us, operations {ch_ops_ms * 1e3:.4f} us, chain floor "
            f"(clusters of 8 / 16) {floors[8][0]:.3f} / {floors[16][0]:.3f} us (pieces, us a "
            f"repetition: {json.dumps({k: round(v, 4) for k, v in pieces.items()})}, the "
            f"busiest block's tiles {floors[8][2]} / {floors[16][2]}); bound "
            f"{ch_bound * 1e3:.4f} us by {bound_by}; at the default cluster of {fk.CLUSTER} "
            f"{binds} binds; "
            f"yardsticks: torch.bmm of the plain Jacobians' Gram {bmm_ms:.5f} ms, "
            f"cholesky_ex + cholesky_solve of the ({L}, 18, 18) damped systems {chol_ms:.5f} ms")
    return recs


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


def plain_pgo_check(np, n, g, out):
    """pgo()'s answer out on the circle graph g of n poses against the plain
    float64 LM of the mapped drive's yardstick (``benchmark/reference_map.py``,
    as its ``pgo_check``): (the program's float64 cost, the plain optimum's,
    their ratio ``pgo_cost_gap`` over an optimum of no less than
    ``COST_FLOOR`` an edge, the largest position gap over the circle's
    diameter of 20 ``pgo_pose_gap``, the plain LM's iterations)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_map", ROOT / "benchmark" / "reference_map.py")
    rm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rm)
    pg = rm.PoseGraph(g[0], np.arange(n), g[1], g[2], g[3], False)
    plain, plain_cost, iters = pg.solve()
    prog = pg.state_of(out)
    cost = pg.cost(prog)
    gap = float(np.linalg.norm(prog[0] - plain[0], axis=1).max()) / 20.0
    return cost, plain_cost, cost / max(plain_cost, rm.COST_FLOOR * len(pg.a)), gap, iters


def phase_pgo(np, torch):
    """pgo() on the card against the CPU at 60 and 600 poses, as given and
    with the chain reduction (reduce_threshold_dofs=0): poses within
    PGO_POSE_TOL. Then pgo() in the SLAM's form (poses_idx given: no chain
    reduction) on the card at PGO_DENSE_SIZES poses, held to the plain
    float64 LM (``plain_pgo_check``) within the mapped drive's limits,
    PGO_COST_GAP and PGO_POSE_GAP, with the time of an LM iteration and the
    peak device memory. Returns the largest card-vs-CPU error."""
    from voldor_tpu_torch.pgo import api as pgo_api

    worst = 0.0
    for n in (60, 600):
        g = circle_graph(np, torch, n, seed=n)
        for kw in ({}, {"reduce_threshold_dofs": 0}):
            out, solves = {}, {}
            for dev in ("cuda", "cpu"):
                dense, reduced = [], []
                with spying(pgo_api, "pgo_solve_dense_jit", dense), \
                        spying(pgo_api, "chain_reduce", reduced):
                    out[dev] = pgo_api.pgo(*g, device=dev, **kw)
                solves[dev] = (("reduced to %d poses, " % len(reduced[0][0])) if reduced else "") + \
                    ", ".join(f"dense {int(r[2])} LM iterations, cost {float(r[1]):.4e}" for r in dense)
            err = _pose_err(np, torch, out["cuda"], out["cpu"])
            worst = max(worst, err)
            log(f"[pgo] pgo() n={n} {kw or ''}: card {solves['cuda']}; cpu {solves['cpu']}; "
                f"poses max err {err:.3e}")
    if worst > PGO_POSE_TOL:
        raise AssertionError(f"PGO on the card disagrees with the CPU run ({worst:.3e})")

    real = pgo_api.pgo_solve_dense_jit
    for n in PGO_DENSE_SIZES:
        g = circle_graph(np, torch, n, seed=n)
        timed = []

        def solve(prob):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real(prob)
            torch.cuda.synchronize()
            timed.append((time.perf_counter() - t0, int(res[2]), float(res[1])))
            return res

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pgo_api.pgo_solve_dense_jit = solve
        try:
            out = pgo_api.pgo(*g, poses_idx=np.arange(n), device="cuda")
        finally:
            pgo_api.pgo_solve_dense_jit = real
        peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cost64, plain_cost, cost_gap, pose_gap, plain_iters = plain_pgo_check(np, n, g, out)
        plain_s = time.perf_counter() - t0
        (dt, iters, cost), = timed
        log(f"[pgo] dense LM n={n} (poses_idx given, D = {7 * n}): {iters} LM iterations in "
            f"{dt:.4f} s, {dt / max(iters, 1) * 1e3:.3f} ms an iteration, cost {cost:.6e} "
            f"(float64 {cost64:.6e}); peak device memory {peak:.3f} GB; the plain float64 LM's "
            f"cost {plain_cost:.6e} ({plain_iters} iterations, {plain_s:.1f} s on the host): "
            f"pgo_cost_gap {cost_gap:.10f} (limit {PGO_COST_GAP}), pgo_pose_gap {pose_gap:.3e} "
            f"(limit {PGO_POSE_GAP})")
        if not (cost_gap <= PGO_COST_GAP and pose_gap <= PGO_POSE_GAP):
            raise AssertionError(f"PGO on the card at {n} poses misses the plain float64 LM: "
                                 f"pgo_cost_gap {cost_gap}, pgo_pose_gap {pose_gap}")
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
    """falign_pairs per call and per batched LM iteration at 4 and 16 pairs
    (with images, the local-link settings), with its launches and host
    syncs, and the 4-pair call split into its set-up (the maps, each
    phase's start), its chunks and its finish (covariances, scores); the
    launches of one chunk of 8 LM iterations alone; the dense PGO per
    solve at 60 and 600 poses."""
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.falign import solver as fsolver
    from voldor_tpu_torch.pgo import solver as pgo_solver

    out = {}
    real_iterate = fsolver.lm_iterate
    for n_pairs in (4, 16):
        _, kw = falign_batch(np, torch, sc, n_pairs, True)
        falign_api.falign_pairs(**kw, device="cuda")  # warm
        batched = [0]  # batched LM iterations: the chunks' lengths

        def counted(prob, st, lanes, stride, n_iters):
            batched[0] += n_iters
            return real_iterate(prob, st, lanes, stride, n_iters)

        times = []
        fsolver.lm_iterate = counted
        try:
            for _ in range(3):
                batched[0] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rets = falign_api.falign_pairs(**kw, device="cuda")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            fsolver.lm_iterate = real_iterate
        chunks = []  # one read of the done flags per chunk of LM iterations
        with spying(fsolver, "lm_iterate", chunks):
            launches, syncs, copies = profile_counts(
                torch, lambda: falign_api.falign_pairs(**kw, device="cuda"))
        call = statistics.median(times)
        lane_its = sum(r["iters"] + r["iters_coarse"] for r in rets)
        out[n_pairs] = dict(call_s=call, per_iter_ms=call / batched[0] * 1e3,
                            batch_iters=batched[0], lane_iters=lane_its, launches=launches,
                            syncs=syncs, copies=copies, host_reads=len(chunks))
        log(f"[times] falign_pairs {n_pairs} pairs (photo + geo, 7-dof, stride 4, coarse 6): "
            f"{call:.4f} s per call (median of 3: {[round(t, 4) for t in times]}), "
            f"{batched[0]} batched LM iterations ({lane_its} lane iterations), "
            f"{call / batched[0] * 1e3:.3f} ms per batched iteration; per call {launches} kernel "
            f"launches ({launches / batched[0]:.3f} per batched iteration, set-up included), "
            f"{syncs} host syncs, {copies} memcpys, {len(chunks)} done-flag reads (three launches "
            f"an iteration made 626 launches and 35 host syncs per 4-pair call)")
    # the 4-pair call split: synchronised timers around its parts
    _, kw = falign_batch(np, torch, sc, 4, True)
    split = dict(maps=0.0, phase_init=0.0, chunks=0.0, covariances=0.0, scores=0.0)

    def timed(key, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t
            return r
        return wrapper

    parts = ((falign_api, "precompute_maps", "maps"), (fsolver, "phase_init", "phase_init"),
             (fsolver, "lm_iterate", "chunks"), (falign_api, "pair_covariances", "covariances"),
             (falign_api, "align_scores", "scores"))
    reals = [getattr(m, name) for m, name, _ in parts]
    for (m, name, key), fn in zip(parts, reals):
        setattr(m, name, timed(key, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        falign_api.falign_pairs(**kw, device="cuda")
        torch.cuda.synchronize()
        whole = time.perf_counter() - t0
    finally:
        for (m, name, _), fn in zip(parts, reals):
            setattr(m, name, fn)
    split["rest"] = whole - sum(split.values())
    out["split_4"] = dict(whole_s=whole, **split)
    log(f"[times] falign_pairs 4 pairs split (synchronised timers, one call of {whole:.4f} s): "
        f"{json.dumps({k: round(v, 5) for k, v in split.items()})} s; set-up (maps + phase "
        f"starts) {split['maps'] + split['phase_init']:.5f} s, chunks {split['chunks']:.5f} s")
    # the launches of the LM iterations alone: one chunk of 8 on the 4-pair
    # batch's maps at stride 4
    prob, params, lanes = falign_kernel_inputs(np, torch, sc, "photo")
    st = fsolver.phase_init(prob, params, lanes, 4)
    fsolver.lm_iterate(prob, st, lanes, 4, 8)
    chunk_launches, chunk_syncs, _ = profile_counts(
        torch, lambda: fsolver.lm_iterate(prob, st, lanes, 4, 8))
    out["lm_chunk"] = dict(iterations=8, launches=chunk_launches, syncs=chunk_syncs,
                           per_iter=chunk_launches / 8)
    log(f"[times] falign LM: a chunk of 8 batched iterations (4 lanes, stride 4) makes "
        f"{chunk_launches} kernel launches, {chunk_launches / 8:.3f} per iteration (three "
        f"launches an iteration: 3.125), and {chunk_syncs} syncs, the profile's own closing "
        f"synchronize included")
    if not 1 <= chunk_launches <= 8 or out[4]["syncs"] > 37:
        raise AssertionError(f"falign: {chunk_launches} launches in a chunk of 8 LM iterations "
                             f"(limit 1 per iteration, at least the chunk's own) or "
                             f"{out[4]['syncs']} host syncs per 4-pair call (limit 37)")
    for n in (60, 600):
        g = circle_graph(np, torch, n, seed=n)
        prob, _, _ = pgo_solver.build_problem(g[0], None, g[1], g[2], g[3], False,
                                              torch.device("cuda"))
        pgo_solver.pgo_solve_dense_jit(prob, max_iters=2)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cost, iters = pgo_solver.pgo_solve_dense_jit(prob)
        iters = int(iters)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[f"pgo_dense_{n}"] = dict(solve_s=dt, iters=iters)
        log(f"[times] PGO dense n={n}: {dt:.4f} s per solve, {iters} LM iterations, "
            f"{dt / max(iters, 1) * 1e3:.3f} ms per iteration, cost {float(cost):.4e}")
    return out


def make_full_slam(sc, loop_closure=True, device="cuda"):
    """VOLDOR_SLAM(mode="mono") configured as bench.py:_make_slam_e2e
    (:301-321): enable_loop_closure() with the built-in vocabulary unless
    loop_closure is False."""
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    slam = VOLDOR_SLAM(mode="mono", device=device)
    slam.set_cam_params(FX, FY, W / 2, H / 2)
    flows = sc["flows"]
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = flows.shape[0]
    slam.images_bgri = list(sc["images_bgri"])
    slam.images_grayf = list(sc["images_grayf"])
    slam.image_loader_pt = len(sc["images_bgri"])
    if loop_closure:
        slam.enable_loop_closure()
    slam.lc_min_kf_distance = 3
    return slam


class _TimedORB:
    """A cv2 ORB detector whose detectAndCompute adds its seconds to a sum."""

    def __init__(self, orb, sums):
        self.orb, self.sums = orb, sums

    def detectAndCompute(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self.orb.detectAndCompute(*a, **k)
        finally:
            self.sums["orb"] += time.perf_counter() - t0


def _time_into(sums, key, fn):
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            sums[key] += time.perf_counter() - t0
    return wrapper


def _overlap(intervals, others):
    """Seconds of intervals that fall inside the union of others."""
    tot = 0.0
    for a0, a1 in intervals:
        for b0, b1 in others:
            tot += max(0.0, min(a1, b1) - max(a0, b0))
    return tot


def run_full_slam(np, torch, sc, check=False, loop_closure=True):
    """One pass of vo_thread + mapping_thread, joined with a timeout as
    bench.py:_run_slam_once does. With loop closure, the host seconds of
    append_kf's loop-closure work: ORB, the retriever's query and add
    (its k-majority refits inside the add) and the geometry check. Returns
    (slam, wall s, stats)."""
    import threading

    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.pgo import api as pgo_api
    from voldor_tpu_torch.slam import system as slam_system

    slam = make_full_slam(sc, loop_closure)
    events, spans, dispatched = [], {"falign": [], "pgo": [], "vo": []}, []
    slam.metrics.log = lambda event, **kw: events.append(dict(event=event, **kw))
    lc_s = {"orb": 0.0, "retrieval": 0.0, "geometry": 0.0}
    refits = []
    if loop_closure:
        slam.feature_detector = _TimedORB(slam.feature_detector, lc_s)
        r = slam.retriever
        r.query_frame = _time_into(lc_s, "retrieval", r.query_frame)
        add = r.add_frame

        def add_frame(*a, **k):
            was = r._n_des_at_train
            t0 = time.perf_counter()
            out = add(*a, **k)
            if r._n_des_at_train != was:
                refits.append((r._n_des_at_train, time.perf_counter() - t0))
            return out

        r.add_frame = _time_into(lc_s, "retrieval", add_frame)

    def spanned(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans[name].append((t0, time.perf_counter()))
        return wrapper

    real = {"falign": falign_api.falign_pairs, "pgo": pgo_api.pgo,
            "geometry": slam_system.geometry_check}
    falign_api.falign_pairs = spanned("falign", real["falign"])
    pgo_api.pgo = spanned("pgo", real["pgo"])
    slam_system.geometry_check = _time_into(lc_s, "geometry", real["geometry"])
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
        slam_system.geometry_check = real["geometry"]
    alive = vo.is_alive() or mp.is_alive()
    links = [e for e in events if e["event"] == "local_link"]
    lc_links = [e for e in events if e["event"] == "lc_link"]
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
        lc_candidates=list(slam.lc_candidates),
        lc_links=[(e["kf_ids"], e["consistency"], e["visibility"], e["accepted"]) for e in lc_links],
        lc_s=lc_s, refits=refits,
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
        if loop_closure:
            names = [e["event"] for e in events]
            after = events[names.index("lc_link"):] if "lc_link" in names else []
            if not slam.lc_candidates:
                raise AssertionError("slam-full-mono: no loop-closure candidate")
            if not lc_links or st["edges"].get("falign-lc", 0) < 1:
                raise AssertionError("slam-full-mono: no loop-closure link or falign-lc edge")
            if not any(e["event"] == "pgo" and e["fid_start"] == 0 for e in after):
                raise AssertionError("slam-full-mono: no global PGO after the loop-closure link")
    return slam, dt, st


def phase_full_slam(np, torch, sc):
    """slam-full-mono, loop closure on: one checked pass with the kernels'
    launches counted, one timed pass, and one timed pass with loop closure
    off for comparison. Returns (launch counts, frames/s of the timed pass,
    ATE)."""
    import cv2

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
    st_checked = st
    log(f"[slam-full-mono] checked pass (loop closure on): {n_frames} frames in {dt0:.4f} s "
        f"({n_frames / dt0:.4f} frames/s); keyframes {len(st['keyframes'])} {st['keyframes']}; "
        f"loop-closure candidates {st['lc_candidates']}, LC links (kf_ids, consistency, "
        f"visibility, accepted) {st['lc_links']}; local links tried "
        f"{st['links']}, accepted {st['accepted']}, rejected by consistency/visibility "
        f"{st['rejected_cv']}, by covariance rank {st['rejected_rank']}; edges {st['edges']}; PGO "
        f"solves (fid_start, n_frames, n_edges, solve_s) {st['pgo']}; falign calls "
        f"{st['falign_calls']}; EM iterations {st['em_iters']}, cost kernel launches "
        f"{counts['cost']} ({counts['score']} in score mode), fb_smooth launches {counts['fb']}; "
        f"falign kernels: linearise {counts['linearize']}, LM chunks {counts['lm_chunk']}")
    log(f"[slam-full-mono] Sim3 ATE {ate:.6f} vs gate {0.02 * extent:.6f} (extent {extent:.4f})")
    check_counts("slam-full-mono", counts, st["em_iters"])
    check_falign_counts("slam-full-mono", counts)
    if not ate < 0.02 * extent:
        raise AssertionError("slam-full-mono: trajectory fails the Sim3-ATE gate")

    slam, dt, st = run_full_slam(np, torch, sc)
    ate_t = ate_of(slam)
    lc = st["lc_s"]
    log(f"[slam-full-mono] timed pass, loop-closure host work in append_kf (cv2 {cv2.__version__}): "
        f"ORB {lc['orb']:.4f} s, retrieval {lc['retrieval']:.4f} s (k-majority refits at "
        f"(descriptors, s of that add) {[(n, round(t, 4)) for n, t in st['refits']]}), geometry "
        f"check {lc['geometry']:.4f} s; {sum(lc.values()):.4f} s in all, "
        f"{100 * sum(lc.values()) / dt:.2f}% of the wall, {100 * sum(lc.values()) / st['vo_s']:.2f}% "
        f"of the VO windows; candidates {st['lc_candidates']}, LC links {st['lc_links']}")
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

    off, dt_off, st_off = run_full_slam(np, torch, sc, loop_closure=False)
    log(f"[slam-full-mono] timed pass, loop closure off (for comparison): {n_frames / dt_off:.4f} "
        f"frames/s ({dt_off:.4f} s); falign {st_off['falign_s']:.4f} s in "
        f"{st_off['falign_calls']} calls, PGO {st_off['pgo_s']:.4f} s, edges {st_off['edges']}, "
        f"Sim3 ATE {ate_of(off):.6f}; with loop closure {n_frames / dt:.4f} frames/s, ATE "
        f"{ate_t:.6f}")
    if st_off["alive"]:
        raise AssertionError("slam-full-mono: the pass with loop closure off did not end")

    def link(st_, pair):
        return [round(c, 4) for k, c, _, _ in st_["lc_links"] if tuple(k) == pair]

    log(f"[C1] the (25, 40) loop-closure link's consistency: checked pass "
        f"{link(st_checked, (25, 40))}, timed pass {link(st, (25, 40))} (gate "
        f"{slam.lc_link_consistency_thresh}); Sim3 ATE with loop closure on: checked {ate:.6f}, "
        f"timed {ate_t:.6f}; off: {ate_of(off):.6f}")
    return counts, n_frames / dt, ate


CLI_H, CLI_W, CLI_F = 370, 1226, 700.0  # KITTI's input size, a focal length at it
# phase 16's child: `python -m voldor_tpu_torch.demo ARGS` (runpy's
# run_module is what -m runs), then the kernels' launch counts of that run
CLI_CHILD = (
    "import json, runpy\n"
    "runpy.run_module('voldor_tpu_torch.demo', run_name='__main__', alter_sys=True)\n"
    "from voldor_tpu_torch.ops import chain_trace, cost, falign_kernels, fb_smooth, meanshift, "
    "p3p, pose_collect, robust_gaussian\n"
    "print('[cli-counts] ' + json.dumps(dict(cost=cost.cost_kernel_launches, "
    "score=cost.cost_score_launches, fb=fb_smooth.fb_smooth_kernel_launches, "
    "ct=chain_trace.chain_trace_launches, "
    "p4p=p3p.p4p_kernel_launches, meanshift=meanshift.meanshift_kernel_launches, "
    "rg=robust_gaussian.rg_kernel_launches, pc=pose_collect.pose_collect_launches, "
    "**falign_kernels.read_counts())))\n"
)


def loader_ab(np, flow_dir):
    """Seconds to read every .flo file of flow_dir through the native
    prefetcher and through the Python reader, twice each, alternating (the
    files were just written: both read the page cache); and whether the
    arrays are equal."""
    from voldor_tpu_torch.native.io import NativeFlowDir
    from voldor_tpu_torch.utils.flow_io import load_flow

    paths = sorted(str(f) for f in Path(flow_dir).glob("*.flo"))

    def native():
        src = NativeFlowDir(str(flow_dir))
        out = [src.get(i) for i in range(len(src))]
        src.close()
        return out, src.native

    times = {"native_s": [], "python_s": []}
    for _ in range(2):
        t = time.perf_counter()
        nat, is_native = native()
        times["native_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        py = [load_flow(f) for f in paths]
        times["python_s"].append(time.perf_counter() - t)
    equal = is_native and len(nat) == len(py) and all(np.array_equal(a, b) for a, b in zip(nat, py))
    return dict(files=len(paths), equal=equal, **times)


def phase_cli(np, torch):
    """The demo CLI on the card at KITTI's input size (see phase 16 in the
    module docstring). Returns (launch counts of the child, frames/s of
    the child's whole run, ATE)."""
    import shutil
    import tempfile

    import cv2

    from voldor_tpu_torch.slam.checkpoint import load_map
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM
    from voldor_tpu_torch.utils.evaluation import ate_rmse
    from voldor_tpu_torch.utils.flow_io import save_flow

    t0 = time.perf_counter()
    sc = build_slam_scene(np, torch, SLAM_E2E_FLOWS, h=CLI_H, w=CLI_W, focal=CLI_F)
    tmp = Path(tempfile.mkdtemp(prefix="_smoke_cli_", dir=ROOT))
    try:
        (tmp / "flow").mkdir()
        (tmp / "image").mkdir()
        for i, fl in enumerate(sc["flows"]):
            save_flow(str(tmp / "flow" / f"{i:06d}.flo"), fl)
        for i, im in enumerate(sc["images_bgri"]):
            cv2.imwrite(str(tmp / "image" / f"{i:06d}.png"), im)
        t_files = time.perf_counter() - t0
        poses, mapf, metrics = tmp / "poses.txt", tmp / "map.npz", tmp / "metrics.jsonl"
        args = ["--mode", "mono", "--flow_dir", str(tmp / "flow"), "--img_dir", str(tmp / "image"),
                "--fx", str(CLI_F), "--fy", str(CLI_F), "--cx", str(CLI_W / 2), "--cy", str(CLI_H / 2),
                "--enable_mapping", "--enable_loop_closure", "--save_poses", str(poses),
                "--save_map", str(mapf), "--metrics", str(metrics)]
        t1 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", CLI_CHILD, *args], capture_output=True,
                             text=True, timeout=600, cwd=ROOT)
        dt = time.perf_counter() - t1
        if out.returncode != 0:
            log(out.stdout[-3000:])
            log(out.stderr[-3000:])
            raise AssertionError(f"the demo CLI exited {out.returncode}")
        counts = json.loads(out.stdout.split("[cli-counts] ")[1].splitlines()[0])
        native = f"{SLAM_E2E_FLOWS} flows loaded (native IO)" in out.stdout
        loader = loader_ab(np, tmp / "flow")
        lines = poses.read_text().strip().split("\n")
        est = np.tile(np.eye(4), (len(lines), 1, 1))
        est[:, :3, :4] = np.array([ln.split() for ln in lines], np.float64).reshape(-1, 3, 4)
        gt = np.linalg.inv(sc["Ts"])
        extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
        ate = ate_rmse(est, gt, with_scale=True) if len(lines) == len(gt) else float("inf")
        slam = VOLDOR_SLAM(mode="mono", device="cuda")
        load_map(slam, str(mapf))
        loaded = np.stack([f.Tcw[:3, :4] for f in slam.frames]).astype(np.float32)
        same = loaded.shape == est[:, :3, :4].shape and bool(
            np.array_equal(loaded, est[:, :3, :4].astype(np.float32)))
        ev = [json.loads(x) for x in metrics.read_text().splitlines()]
        kinds = {k: sum(e["event"] == k for e in ev) for k in ("vo_window", "local_link", "lc_link", "pgo")}
        lc = [(e["kf_ids"], e["accepted"]) for e in ev if e["event"] == "lc_link"]
        cands = list(slam.lc_candidates)
        n_frames = SLAM_E2E_FLOWS + 1
        log(f"[cli] {CLI_W}x{CLI_H} -> {CLI_W // 2}x{CLI_H // 2}: {n_frames} flows "
            f"and images written in {t_files:.4f} s; python -m voldor_tpu_torch.demo exit 0 in "
            f"{dt:.4f} s ({n_frames / dt:.4f} frames/s over the whole child, start-up and "
            f"loaders included); {len(lines)} poses, Sim3 ATE {ate:.6f} vs gate "
            f"{0.02 * extent:.6f}; map keyframes {slam.kf_ids}, edges "
            f"{ {t: sum(e.edge_type == t for e in slam.edges) for t in sorted({e.edge_type for e in slam.edges})} }; "
            f"load_map poses equal to the pose file {same}; metrics events {kinds}, loop-closure "
            f"candidates {cands}, LC links {lc}; "
            f"cost kernel launches {counts['cost']} ({counts['score']} in score mode), fb_smooth "
            f"{counts['fb']}, falign linearise / LM chunks {counts['linearize']} / "
            f"{counts['lm_chunk']}, P4P / meanshift / robust Gaussian {counts['p4p']} / "
            f"{counts['meanshift']} / {counts['rg']}; the child's flow "
            f"loader took the native prefetcher {native}; "
            f"reading the {SLAM_E2E_FLOWS} .flo files at {CLI_W}x{CLI_H} here: {json.dumps(loader)}")
        if not native:
            raise AssertionError("the demo CLI's flow loader did not take the native prefetcher")
        if not loader["equal"]:
            raise AssertionError("the native loader's arrays differ from the Python reader's")
        if len(lines) != n_frames or not ate < 0.02 * extent:
            raise AssertionError("the demo CLI's poses fail the gate")
        if not same:
            raise AssertionError("load_map does not give the poses the CLI saved")
        if counts["cost"] < 1 or counts["fb"] < 1:
            raise AssertionError(f"the CLI run did not launch both kernels: {counts}")
        check_falign_counts("the CLI run", counts)
        check_pose_counts("the CLI run", counts)
        return counts, n_frames / dt, ate
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the JAX package's golden oracle (tests/test_parity.py:45-49) and the clean
# limits it holds the shipped fast path to there (tests/test_parity.py:150-160)
REFERENCE_EXACT = (
    " --pose_window_sweep seq --pose_collect_mode traced --depth_cost_mode projected"
    " --pose_sample_stride 1 --prior_sample_mode round"
)
PARITY_ATE = 0.02  # mutual Sim3 ATE over the oracle's extent
PARITY_DEPTH = 0.05  # median gauge-normalised relative keyframe-depth deviation
SIBLINGS = {  # the oracle's sibling options, each over the first 2 windows
    "ap3p": " --lambdatwist 0",
    "exact-prop": " --depth_local_prop_mode exact --depth_cost_mode projected",
    "hybrid-traced": " --pose_window_sweep hybrid --pose_collect_mode traced",
}


def parity_readings(np, fast, oracle):
    """tests/test_parity.py's two readings of a pass against the oracle
    pass: the Sim3 ATE of its trajectory over the oracle's extent, and the
    median over the keyframes both passes made of the median relative
    deviation of the gauge-normalised depth. Returns (ate, depth_dev,
    shared keyframe ids)."""
    from voldor_tpu_torch.utils.evaluation import ate_rmse

    ta = np.stack([f.Tcw for f in fast.frames]).astype(np.float64)
    tb = np.stack([f.Tcw for f in oracle.frames]).astype(np.float64)
    extent = float(np.linalg.norm(tb[:, :3, 3] - tb[0, :3, 3], axis=1).max())
    ate = ate_rmse(ta, tb, with_scale=True) / max(extent, 1e-9)
    shared = sorted(set(fast.kf_ids) & set(oracle.kf_ids))
    devs = []
    for fid in shared:
        da = np.asarray(fast.frames[fid].depth, np.float64)
        db = np.asarray(oracle.frames[fid].depth, np.float64)
        da = da * (np.median(db) / max(np.median(da), 1e-9))
        devs.append(float(np.median(np.abs(da - db) / np.maximum(db, 1e-3))))
    return ate, (float(np.median(devs)) if devs else float("inf")), shared


def phase_reference_exact(np, torch, scene, gt):
    """slam-mono reference-exact (phase 18 in the module docstring). Returns
    the oracle's launch counts and a dict of its readings."""
    import shutil
    import tempfile

    from voldor_tpu_torch.utils.evaluation import ate_rmse
    from voldor_tpu_torch.vo import em as em_mod
    from voldor_tpu_torch.vo.api import voldor_dispatch
    from voldor_tpu_torch.vo.engine import save_result

    t_phase = time.perf_counter()
    flows = scene[3]
    n_frames = flows.shape[0] + 1
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    rec = {}

    # the oracle, checked, with the projected cost's calls timed
    cost_s = [0.0, 0]
    orig_cost = em_mod.compute_cost_map

    def timed_cost(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_cost(*a, **k)
        torch.cuda.synchronize()
        cost_s[0] += time.perf_counter() - t
        cost_s[1] += 1
        return out

    em_mod.compute_cost_map = timed_cost
    reset_counts()
    try:
        oracle, dt0, st = run_slam_pass(np, torch, "mono", flows, check=True, user_config=REFERENCE_EXACT)
    finally:
        em_mod.compute_cost_map = orig_cost
    counts = read_counts()
    ate = ate_rmse(np.stack([f.Tcw for f in oracle.frames]).astype(np.float64), gt, with_scale=True)
    rec.update(oracle_ate=ate, cost_map_calls=cost_s[1], cost_map_s=cost_s[0], checked_s=dt0,
               cost_map_share=cost_s[0] / dt0)
    log(f"[refexact] oracle checked pass: {n_frames} frames in {dt0:.4f} s; windows "
        f"{st['windows']}, keyframes {st['keyframes']} {oracle.kf_ids}, vo_steps {st['vo_steps']}, "
        f"EM iterations {st['em_iters']}; cost kernel launches {counts['cost']}, fb_smooth kernel "
        f"launches {counts['fb']}, P4P / meanshift / robust Gaussian {counts['p4p']} / "
        f"{counts['meanshift']} / {counts['rg']}; projected cost maps {cost_s[1]} taking {cost_s[0]:.4f} s "
        f"({100.0 * cost_s[0] / dt0:.1f}% of the pass, synchronised timers); Sim3 ATE {ate:.6f} "
        f"vs gate {0.02 * extent:.6f}")
    if counts["cost"] != 0:
        raise AssertionError(f"the oracle launched the cost kernel {counts['cost']} times")
    if counts["fb"] < 1 or cost_s[1] < 1:
        raise AssertionError(f"the oracle's depth rounds did not run: fb {counts['fb']}, "
                             f"projected cost maps {cost_s[1]}")
    check_pose_counts("the oracle", counts)
    if not ate < 0.02 * extent:
        raise AssertionError("the oracle fails the Sim3-ATE gate")
    oracle, dt, st = run_slam_pass(np, torch, "mono", flows, user_config=REFERENCE_EXACT)
    ate_t = ate_rmse(np.stack([f.Tcw for f in oracle.frames]).astype(np.float64), gt, with_scale=True)
    rec.update(oracle_fps=n_frames / dt, oracle_s=dt, oracle_em_iters=st["em_iters"])
    log(f"[refexact] oracle timed pass: {n_frames / dt:.4f} frames/s ({dt:.4f} s), EM iterations "
        f"{st['em_iters']}, Sim3 ATE {ate_t:.6f}")
    if not ate_t < 0.02 * extent:
        raise AssertionError("the oracle's timed pass fails the Sim3-ATE gate")

    # the shipped fast path against the oracle
    fast, dt_f, _ = run_slam_pass(np, torch, "mono", flows)
    m_ate, m_dep, shared = parity_readings(np, fast, oracle)
    rec.update(fast_fps=n_frames / dt_f, mutual_ate=m_ate, depth_dev=m_dep, shared_kf=shared)
    log(f"[refexact] fast path ({n_frames / dt_f:.4f} frames/s) vs the oracle: mutual Sim3 ATE / "
        f"extent {m_ate:.6f} (limit {PARITY_ATE}), median keyframe-depth deviation {m_dep:.6f} "
        f"(limit {PARITY_DEPTH}) over the shared keyframes {shared} (fast {fast.kf_ids})")
    if not (m_ate < PARITY_ATE and m_dep < PARITY_DEPTH):
        raise AssertionError("the fast path is outside the parity limits of the oracle")

    # the sibling options, each over the first 2 windows
    gt2 = np.linalg.inv(scene[5][:2 * WINDOW + 1])
    ext2 = float(np.linalg.norm(gt2[:, :3, 3] - gt2[0, :3, 3], axis=1).max())
    for name, extra in SIBLINGS.items():
        est, walls, iters, _ = run_sequence(np, torch, scene, check=True, n_windows=2,
                                            extra_config=extra)
        a = ate_rmse(est.astype(np.float64), gt2, with_scale=True)
        rec[f"{name}_ate"] = a
        rec[f"{name}_s"] = sum(walls)
        log(f"[refexact] {name} ({extra.strip()}): 2 windows in {sum(walls):.4f} s, EM iterations "
            f"{iters}, Sim3 ATE {a:.6f} vs gate {0.02 * ext2:.6f}")
        if not a < 0.02 * ext2:
            raise AssertionError(f"{name}: fails the Sim3-ATE gate")

    # the debug entry points
    tmp = Path(tempfile.mkdtemp(prefix="_smoke_refexact_", dir=ROOT))
    try:
        win = voldor_dispatch(flows[:WINDOW], FX, FY, W / 2, H / 2, basefocal=BASEFOCAL,
                              config=CONFIG + " --save_everything --kitti_estimate_ground 1",
                              device="cuda")
        win.collect()
        eng = win.engine
        save_result(eng, str(tmp / "result"))
        want = {"depth.npy", "depth.png", "camera_pose.txt", "rigidness_sum.npy"}
        want |= {f"{k}-{i}.npy" for k in ("rigidness", "flow-viz") for i in range(WINDOW)}
        got = set(p.name for p in (tmp / "result").iterdir())
        if got != want:
            raise AssertionError(f"save_result wrote {sorted(got)}, expected {sorted(want)}")
        if not np.array_equal(np.load(tmp / "result" / "depth.npy"), eng.depth.cpu().numpy()):
            raise AssertionError("save_result's depth.npy is not the engine's depth")
        n_lines = len((tmp / "result" / "camera_pose.txt").read_text().strip().split("\n"))
        g = eng.ground
        if n_lines != eng.n_flows or g is None or not (
                np.isfinite(g.height) and np.isfinite(g.normal).all()):
            raise AssertionError(f"save_result pose lines {n_lines}, KITTI ground {g}")
        log(f"[refexact] save_result: {len(got)} files, depth.npy equal to the engine's depth, "
            f"{n_lines} pose lines; KITTI ground height {g.height:.6f}, normal {g.normal.tolist()}, "
            f"confidence {g.confidence:.4f}")
        n_dbg = 3 * WINDOW
        slam = make_slam("mono", flows[:n_dbg])
        slam.debug_dir = str(tmp / "debug")
        fids = []
        while True:
            fid = slam.fid_cur
            if not slam.process_vo():
                break
            fids.append(fid)
        for fid in fids:
            for part in ("depth.npy", "depth_conf.npy", "rigidness.npy", "invdepth.png"):
                if not (tmp / "debug" / f"window_{fid:06d}_{part}").exists():
                    raise AssertionError(f"debug_dir: window {fid} has no {part}")
        log(f"[refexact] debug_dir over {len(slam.flows)} flows: windows at {fids}, "
            f"{len(list((tmp / 'debug').iterdir()))} files")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[refexact] phase {rec['phase_s']:.1f} s: {json.dumps(rec)}")
    return counts, rec


def pose_records(rec, err, ab, paths, path_names):
    """The kernels-line records of the pose sweep's three kernels: the
    Jacobi sweep's shape (B = 5) in the required keys, B = 1 beside it."""
    meta = (("p4p", "p4p", "p4p_kernel.cu", "voldor_tpu/ops/p3p.py:300", "p4p_max_err"),
            ("meanshift", "meanshift", "meanshift_kernel.cu", "voldor_tpu/ops/meanshift.py:38",
             "ms_max_err"),
            ("robust_gaussian", "rg", "robust_gaussian_kernel.cu",
             "voldor_tpu/ops/robust_gaussian.py:102", "rg_max_err"))
    out = []
    for name, key, src, replaces, err_key in meta:
        r5, r1 = rec[WINDOW][key], rec[1][key]
        entry = {
            "name": name, "route": "cuda", "source": f"voldor_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": sum(c[key] for c in paths),
            "launches_by_path": {n: c[key] for n, c in zip(path_names, paths)},
            "max_abs_err": err[err_key],
            "ms": r5["ms"], "plain_ms": r5["plain_ms"], "bound_ms": r5["bound_ms"],
            "bound_us": r5["bound_ms"] * 1e3, "bound_by": r5["bound_by"], "library_ms": None,
            "shape": f"B={WINDOW} (the Jacobi sweep), S={N_POSES}",
            "b1": {k: r1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        }
        if key != "p4p":
            entry.update(iters=r5["iters"], chain_floor_us=r5["chain_floor_ms"] * 1e3,
                         chain_floor_us_b1=r1["chain_floor_ms"] * 1e3, iters_b1=r1["iters"])
        else:
            entry.update(wrapper_ms=r5["wrapper_ms"], M=r5["M"])
        if key == "meanshift":
            entry["ground_pool_max_abs_err"] = err["ms_ground_err"]
            entry["block_sum_ns"] = rec["probe_ns"]
        out.append(entry)
    out[0]["pose_ab"] = ab
    return out


def main():
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU.")
    ap.add_argument("--parent", default=None,
                    help="another checkout (e.g. the parent commit unpacked from git archive): "
                         "its fb_smooth and cost kernels are timed beside this tree's "
                         "(tools/fb_smooth_ab.py, tools/cost_kernel_ab.py)")
    opt = ap.parse_args()
    # a stall anywhere ends the run with every thread's stack, inside the
    # card machine's time limit (the whole run takes ~300 s)
    faulthandler.dump_traceback_later(STALL_S, exit=True)
    t_run = time.perf_counter()
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
    fb_err, fb_chunk_err = phase_fb(np, torch, bi)
    score_err = phase_score(np, torch, bi, scene)
    accept_frac = phase_accept(np, torch, bi, scene)
    chain_err, chain_bitwise = phase_chain_trace(np, torch, bi)
    collect_in = collect_inputs(torch, bi)
    collect_cases_n = phase_pose_collect(np, torch, bi, collect_in)
    pose_cap = capture_pose_inputs(np, torch, scene)
    pose_err = phase_pose_kernels(np, torch, pose_cap)
    pose_ab = phase_pose_ab(np, torch, scene)
    pose_ab["fuse_launches"] = fuse_launches(torch, pose_cap)
    fb_rec, cost_rec = phase_times(np, torch, bi, sass, opt.parent)
    pose_rec = pose_times(np, torch, pose_cap)
    chain_rec = chain_trace_times(np, torch, bi)
    collect_rec = pose_collect_times(np, torch, bi, collect_in)
    # the full-SLAM scene of the mapping half (phases 12-16); the falign
    # kernels' times at its batches' shapes
    sc = build_slam_scene(np, torch, SLAM_E2E_FLOWS)
    falign_rec = falign_times(np, torch, sc)

    # the slice, counted: every launch from here on is the main path's;
    # the cost kernel's launches in each depth round too
    rounds = []
    round_core = engine_mod._depth_round_core

    def counted_round(*a, **k):
        from voldor_tpu_torch.ops import cost as cost_mod

        before = cost_mod.cost_kernel_launches
        out = round_core(*a, **k)
        rounds.append(cost_mod.cost_kernel_launches - before)
        return out

    reset_counts()
    engine_mod._depth_round_core = counted_round
    try:
        est, walls0, iters, route = run_sequence(np, torch, scene, check=True)
    finally:
        engine_mod._depth_round_core = round_core
    win_counts = read_counts()
    # a depth round's cost launches (over the rounds that launch it: the
    # flow-fed ones), each shape the main path launched at its phase-6
    # time (and at each checkout's, with --parent)
    shapes = win_counts["shapes"]
    fed = sum(1 for n in rounds if n > 0)
    round_ms = depth_round_ms(cost_rec["ms_by_shape"], shapes, fed)
    parent_round = None
    if cost_rec["parent"] is not None:
        parent_round = {name: depth_round_ms(cost_rec["parent"][name]["ms"], shapes, fed)
                        for name in ("a", "b")}
    round_launches = dict(collections.Counter(rounds))
    log(f"[slice] cost kernel launches by shape over the windows' {len(rounds)} depth rounds "
        f"(rounds by their launches: {round_launches}): {shapes}; a flow-fed round's cost launches "
        f"{round_ms:.5f} ms at phase 6's device times"
        + ("" if parent_round is None else
           f"; through each checkout's wrapper (tools/cost_kernel_ab.py) the parent's "
           f"{parent_round['a']:.5f} ms, this tree's {parent_round['b']:.5f} ms "
           f"({parent_round['a'] / parent_round['b']:.3f}x)"))
    log(f"[slice] bootstrap route: {route}; EM iterations per window {iters}; "
        f"cost kernel launches {win_counts['cost']} ({win_counts['score']} in score mode), "
        f"fb_smooth kernel launches {win_counts['fb']}, chain trace kernel launches "
        f"{win_counts['ct']}, P4P / meanshift / robust Gaussian "
        f"{win_counts['p4p']} / {win_counts['meanshift']} / {win_counts['rg']}, pose collect "
        f"{win_counts['pc']}; cold wall s "
        f"{[round(x, 4) for x in walls0]}")
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
        f"frames/s (metric ATE {ate_st:.6f}); launches cost / fb_smooth / P4P / meanshift / robust "
        f"Gaussian: windows {[win_counts[k] for k in ('cost', 'fb') + POSE_KERNELS]}, mono pass "
        f"{[mono[k] for k in ('cost', 'fb') + POSE_KERNELS]}, stereo pass "
        f"{[stereo[k] for k in ('cost', 'fb') + POSE_KERNELS]}")

    # the mapping half: falign and PGO against their CPU runs, their times,
    # then the full SLAM pass (VO + mapping thread) on the bench's scene
    falign_err = phase_falign(np, torch, sc)
    fk_err = phase_falign_kernels(np, torch, sc)
    pgo_err = phase_pgo(np, torch)
    mapping_times = phase_mapping_times(np, torch, sc)
    full, fps_full, ate_full = phase_full_slam(np, torch, sc)
    log(f"[mapping] falign card vs CPU {falign_err}; PGO card vs CPU {pgo_err:.3e}; slam-full-mono "
        f"{fps_full:.4f} frames/s (Sim3 ATE {ate_full:.6f}) beside slam-mono {fps_mono:.4f}; "
        f"launches cost / fb_smooth on the full pass {full['cost']} / {full['fb']}; "
        f"times {json.dumps(mapping_times)}")
    cli, fps_cli, ate_cli = phase_cli(np, torch)
    mscaled, fps_ms, ate_ms = phase_slam(np, torch, "mono-scaled", flows, gt, disps=disps, n_timed=1)
    log(f"[slam] mono-scaled {fps_ms:.4f} frames/s (metric ATE {ate_ms:.6f}); the CLI "
        f"{fps_cli:.4f} frames/s over its whole run (Sim3 ATE {ate_cli:.6f}); launches cost / "
        f"fb_smooth: CLI {cli['cost']} / {cli['fb']}, mono-scaled {mscaled['cost']} / {mscaled['fb']}")
    refexact, ref_rec = phase_reference_exact(np, torch, scene, gt)
    log(f"[refexact] oracle {ref_rec['oracle_fps']:.4f} frames/s beside the fast path's "
        f"{ref_rec['fast_fps']:.4f} in the same phase; projected cost "
        f"{100.0 * ref_rec['cost_map_share']:.1f}% of a checked oracle pass")
    paths = (win_counts, mono, stereo, full, cli, mscaled, refexact)
    path_names = ("windows", "slam-mono", "slam-stereo", "slam-full-mono", "cli", "mono-scaled",
                  "refexact")

    log(f"[run] {time.perf_counter() - t_run:.1f} s from the device check to here")
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
            "chain_floor_new_us": fb_rec["chain_floor_new_ms"] * 1e3,
            "chain_step_pair_ns": fb_rec["chain_step_pair_ns"],
            "combine_pair_ns": fb_rec["combine_pair_ns"],
            "parent_ms": fb_rec["parent_ms"],
            "parent_ab": fb_rec["parent_ab"],
            "max_abs_err_chunked": fb_chunk_err,
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
            "bound_us_by_k": cost_rec["bound_us_by_k"],
            "ms_by_shape": cost_rec["ms_by_shape"],
            "launches_by_shape": shapes,
            "depth_rounds_by_launches": round_launches,
            "depth_round_ms": round_ms,
            "depth_round_ms_ab": parent_round,
            "issue_floor_us_by_k": cost_rec["issue_floor_us"],
            "sass_per_term": cost_rec["sass_per_term"],
            "registers": cost_rec["registers"],
            "spill_bytes": cost_rec["spill_bytes"],
            "warps_per_sm_by_k": cost_rec["warps_per_sm"],
            "waves_by_k": cost_rec["waves"],
            "pow_m2_bitwise": cost_rec["pow_m2"],
            "parent_ab": cost_rec["parent"],
        },
        {
            "name": "falign_linearize",
            "route": "cuda",
            "source": "voldor_tpu_torch/csrc/falign_linearize.cu",
            "replaces": "voldor_tpu/falign/residual.py:207",
            "launches": sum(c.get("linearize", 0) for c in paths),
            "launches_by_path": {n: c.get("linearize", 0) for n, c in zip(path_names, paths)},
            "max_abs_err": fk_err["blocks_abs"],
            "max_rel_err": fk_err["blocks"],
            "ms": falign_rec["photo"]["ms"]["linearize"],
            "plain_ms": falign_rec["photo"]["plain_ms"]["linearize"],
            "bound_ms": falign_rec["photo"]["linearize_bound_ms"],
            "bound_by": falign_rec["photo"]["linearize_bound_by"],
            "library_ms": None,
            "scores_ms": falign_rec["photo"]["ms"]["scores"],
            "scores_plain_ms": falign_rec["photo"]["plain_ms"]["scores"],
            "scores_bound_ms": falign_rec["photo"]["scores_bound_ms"],
            "bmm_gram_ms": falign_rec["photo"]["bmm_gram_ms"],
            "ms_by_cluster": falign_rec["photo"]["ms_by_cluster"],
            "lc_stride3": {k: falign_rec["lc"][k] for k in (
                "ms", "ms_by_cluster", "plain_ms", "linearize_bound_ms", "linearize_bound_by",
                "scores_bound_ms", "bmm_gram_ms")},
        },
        {
            "name": "falign_lm",
            "route": "cuda",
            "source": "voldor_tpu_torch/csrc/falign_lm.cu",
            "replaces": "voldor_tpu/falign/solver.py:184",
            "launches": sum(c.get("lm_chunk", 0) for c in paths),
            "launches_by_path": {n: c.get("lm_chunk", 0) for n, c in zip(path_names, paths)},
            "max_abs_err": fk_err["step_abs"],
            "max_rel_err": fk_err["step"],
            "max_rel_err_state": fk_err["state"],
            "ms": falign_rec["photo"]["chunk"][falign_rec["photo"]["cluster"]]["ms"],
            "plain_ms": falign_rec["photo"]["plain_ms"]["chunk_per_iter"],
            "bound_ms": falign_rec["photo"]["lm_bound_ms"],
            "bound_by": falign_rec["photo"]["lm_bound_by"],
            "library_ms": None,
            "unit": "one batched LM iteration of a chunk of 8 (4 lanes, stride 4)",
            "cluster": falign_rec["photo"]["cluster"],
            "chunk_by_cluster": falign_rec["photo"]["chunk"],
            "bytes_bound_ms": falign_rec["photo"]["lm_bytes_ms"],
            "ops_bound_ms": falign_rec["photo"]["lm_ops_ms"],
            "chain_floor_us": falign_rec["photo"]["chain_floor_us"],
            "binds": falign_rec["photo"]["lm_binds"],
            "chain_floor_by_cluster_us": falign_rec["photo"]["chain_floor_by_cluster_us"],
            "chain_pieces_us": falign_rec["photo"]["chain_pieces_us"],
            "cholesky_yardstick_ms": falign_rec["photo"]["cholesky_ms"],
            "launches_per_lm_iteration": mapping_times["lm_chunk"]["per_iter"],
            "lc_stride3": {k: falign_rec["lc"][k] for k in (
                "chunk", "plain_ms", "lm_bound_ms", "lm_bound_by", "chain_floor_us",
                "chain_floor_by_cluster_us", "cholesky_ms")},
        },
        *pose_records(pose_rec, pose_err, pose_ab, paths, path_names),
        {
            "name": "chain_trace",
            "route": "cuda",
            "source": "voldor_tpu_torch/csrc/chain_trace.cu",
            "replaces": "voldor_tpu_torch/ops/chain_trace.py:chain_trace_reference "
                        "(voldor_tpu/vo/em.py:95, :325, :332)",
            "launches": sum(c["ct"] for c in paths),
            "launches_by_path": {n: c["ct"] for n, c in zip(path_names, paths)},
            "max_abs_err": chain_err,
            "rigidness_bitwise_share": chain_bitwise,
            "library_ms": None,
            **chain_rec,
        },
        {
            "name": "pose_collect",
            "route": "cuda",
            "source": "voldor_tpu_torch/csrc/pose_collect.cu",
            "replaces": "voldor_tpu_torch/vo/pose_step.py:collect_p3p_instances, "
                        "collect_p3p_instances_obs (voldor_tpu/vo/pose_step.py:37, :290)",
            "launches": sum(c["pc"] for c in paths),
            "launches_by_path": {n: c["pc"] for n, c in zip(path_names, paths)},
            "max_abs_err": 0.0,
            "bitwise_cases": collect_cases_n,
            "library_ms": None,
            "shape": f"obs at active_n={WINDOW} (the Jacobi sweep); traced at target {WINDOW - 1}",
            **collect_rec,
        },
    ]}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
