"""VOLDOR-SLAM demo CLI of the port: the flags, defaults and thread wiring of
``demo/demo.py`` (the JAX package's), driving ``voldor_tpu_torch``.

    python -m voldor_tpu_torch.demo --mode mono --flow_dir FLOWS --img_dir IMAGES \\
        --fx 700 --fy 700 --cx 613 --cy 185 --enable_mapping --enable_loop_closure \\
        --save_poses poses.txt

Loader threads feed flows (``.flo``), images and disparities; the VO thread
and, with ``--enable_mapping``, the mapping thread run to the end of the
sequence; the epilogue writes the poses, depth maps, point cloud and map
checkpoint asked for. It runs on the CUDA device (``--device cpu`` for a
CPU run). ``--viewer`` opens the GL map window (``slam/gl_viewer.py``) where
a display and PyOpenGL exist, and otherwise runs headless, as without it;
``--debug_dir`` writes every window's depth, confidence and rigidness maps
(``utils/debug_viz.py``).
"""

from __future__ import annotations

import argparse
import os
import threading


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="VOLDOR-SLAM (PyTorch + CUDA) demo script")
    parser.add_argument("--mode", type=str, required=True,
                        help="One of stereo/mono-scaled/mono. stereo and mono-scaled need disparity input.")
    parser.add_argument("--flow_dir", type=str, required=True)
    parser.add_argument("--disp_dir", type=str)
    parser.add_argument("--img_dir", type=str)
    parser.add_argument("--fx", type=float, required=True)
    parser.add_argument("--fy", type=float, required=True)
    parser.add_argument("--cx", type=float, required=True)
    parser.add_argument("--cy", type=float, required=True)
    parser.add_argument("--bf", type=float, default=0,
                        help="Baseline x focal (world scale). 0 = auto virtual baseline.")
    parser.add_argument("--resize", type=float, default=0.5)
    parser.add_argument("--abs_resize", type=float,
                        help="Resize factor relative to the flow network's native size.")
    parser.add_argument("--enable_loop_closure", type=str, default=None, nargs="?", const="builtin",
                        help="bare: the built-in online vocabulary; a path: a DBoW vocabulary")
    parser.add_argument("--enable_mapping", action="store_true")
    parser.add_argument("--save_poses", type=str)
    parser.add_argument("--save_depths", type=str)
    parser.add_argument("--save_ply", type=str)
    parser.add_argument("--save_map", type=str, help="write a resumable map checkpoint at the end")
    parser.add_argument("--load_map", type=str, help="resume from a map checkpoint")
    parser.add_argument("--viewer", action="store_true",
                        help="the interactive GL map window (needs a display and PyOpenGL; "
                             "headless otherwise)")
    parser.add_argument("--metrics", type=str,
                        help="write per-window/link/PGO JSON-line metrics to this file")
    parser.add_argument("--debug_dir", type=str,
                        help="dump per-window debug artifacts (rigidness mosaics, inverse depth, "
                             "confidences) to this directory (reference --debug, voldor.cpp:378-396)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    opt = parser.parse_args(argv)
    if opt.abs_resize is None:
        opt.abs_resize = opt.resize
    return opt


def main(argv=None):
    opt = parse_args(argv)
    print(opt)
    watchdog = os.environ.get("VOLDOR_WATCHDOG")
    if watchdog:
        # periodic tracebacks of every thread to stderr, for a stalled run
        import faulthandler

        try:
            seconds = int(watchdog)
        except ValueError:
            raise SystemExit(f"VOLDOR_WATCHDOG must be a whole number of seconds, not {watchdog!r}")
        faulthandler.dump_traceback_later(seconds, repeat=True)
    from voldor_tpu_torch.slam.checkpoint import load_map
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM
    from voldor_tpu_torch.slam.viewer import VOLDOR_Viewer

    slam = VOLDOR_SLAM(mode=opt.mode, device=opt.device)
    slam.set_cam_params(opt.fx, opt.fy, opt.cx, opt.cy, opt.bf, rescale=opt.resize)
    slam.voldor_user_config = f"--abs_resize_factor {opt.abs_resize}"
    if opt.metrics:
        slam.metrics.open(opt.metrics)
    if opt.debug_dir:
        slam.debug_dir = opt.debug_dir

    if opt.enable_loop_closure is not None:
        slam.enable_loop_closure(
            None if opt.enable_loop_closure == "builtin" else opt.enable_loop_closure)

    if opt.load_map:
        load_map(slam, opt.load_map)

    threading.Thread(target=slam.flow_loader,
                     kwargs={"flow_path": opt.flow_dir, "resize": opt.resize}, daemon=True).start()
    slam.flow_loader_sync(0, block_when_uninit=True)

    if opt.img_dir is not None:
        threading.Thread(target=slam.image_loader, kwargs={"image_path": opt.img_dir},
                         daemon=True).start()
        slam.image_loader_sync(0, block_when_uninit=True)
        slam.use_image_info = True
    else:
        slam.use_image_info = False

    if opt.disp_dir is not None:
        threading.Thread(target=slam.disp_loader, kwargs={"disp_path": opt.disp_dir},
                         daemon=True).start()
        slam.disp_loader_sync(0, block_when_uninit=True)

    # the live GL window when asked for and a display exists; the headless
    # watch loop otherwise (the same data path, slam/gl_viewer.py)
    from voldor_tpu_torch.slam.gl_viewer import GLViewer

    gl = None
    if opt.viewer and GLViewer.available():
        gl = GLViewer(slam)
    elif opt.viewer:
        print("Note: --viewer requested but no DISPLAY/PyOpenGL; headless.")
    viewer = VOLDOR_Viewer(slam)
    if gl is None:
        threading.Thread(target=viewer.start, daemon=True).start()

    errors = []

    def guarded(fn):
        # a thread that dies ends the VO stream, so that the other one ends
        # too and the run exits non-zero instead of waiting forever
        def run():
            try:
                fn()
            except BaseException as e:
                errors.append(e)
                slam.end_of_vo = True
                raise
        return run

    threads = [threading.Thread(target=guarded(slam.vo_thread))]
    if opt.enable_mapping:
        threads.append(threading.Thread(target=guarded(slam.mapping_thread)))
    for t in threads:
        t.start()
    done = [False]

    def run_epilogue():
        # once: on the normal path, or from the GL window's 'q' handler,
        # which classic GLUT cannot return from
        if not done[0]:
            done[0] = True
            epilogue(slam, viewer, opt)

    if gl is not None:
        gl.on_exit = run_epilogue
        # with freeglut the loop returns on 'q' or when the threads are done
        gl.start(done=lambda: not any(t.is_alive() for t in threads))
    for t in threads:
        t.join()
    if errors:
        raise SystemExit(f"the SLAM threads failed: {errors!r}")

    run_epilogue()
    slam.metrics.close()
    return slam


def epilogue(slam, viewer, opt):
    """The outputs asked for on the command line (demo/demo.py:_epilogue)."""
    from voldor_tpu_torch.slam.checkpoint import save_map

    if opt.save_poses is not None:
        slam.save_poses(opt.save_poses, format="KITTI")
    if opt.save_depths is not None:
        slam.save_depth_maps(opt.save_depths)
    if opt.save_ply is not None:
        viewer.save_ply(opt.save_ply)
    if opt.save_map is not None:
        save_map(slam, opt.save_map)


if __name__ == "__main__":
    main()
