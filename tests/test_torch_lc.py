"""Loop closure in the port (voldor_tpu_torch/slam/loop_closure.py, the
loop-closure branch of VOLDOR_SLAM and its link blur) against the JAX
package, on the CPU.

* The SLAM layer's blur (_gblur) equal to the JAX package's at widths 3, 5,
  7 and 9, with cv2 (both take cv2.GaussianBlur: bitwise) and without it
  (both take their own separable blur: within 1e-6).
* The retrieval numpy: _hamming_dist, _kmajority and BowRetriever (a cold
  start and k-majority refits) bitwise equal; the committed DBoW vocabulary
  quantises identically; binary vocabularies round-trip across packages.
* geometry_check and append_kf over a revisit sequence of textured
  keyframes: the same inlier rates and lc_candidates with the built-in and
  the file vocabulary (cv2's RANSAC RNG seeded before each call, on one
  thread, as cv2 keeps one RNG per thread).
* Bilinear sampling at a NaN coordinate gives NaN and stays in range.
* vo_thread + mapping_thread with loop closure on at 128x192, out and back:
  a loop-closure link is dispatched and its edges enter the map.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from voldor_tpu.slam import loop_closure as jlc
from voldor_tpu.slam import slam_utils as jsu
from voldor_tpu.slam.frame import Frame as JFrame
from voldor_tpu.slam.system import VOLDOR_SLAM as JSLAM
from voldor_tpu_torch.ops.image import bilinear_sample, bilinear_sample_packed_grad
from voldor_tpu_torch.ops.lie import so3_exp
from voldor_tpu_torch.slam import loop_closure as tlc
from voldor_tpu_torch.slam import slam_utils as tsu
from voldor_tpu_torch.slam.frame import Frame as TFrame
from voldor_tpu_torch.slam.system import VOLDOR_SLAM as TSLAM
from voldor_tpu_torch.utils.evaluation import ate_rmse

from synthetic import plane_depth, render_window
from test_loop_closure import _perturb, _textured_place

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "vocab_k10L4.txt.gz")


# --------------------------------------------------------------------------
# the link blur
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_cv2", [True, False])
@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_gblur_matches_jax(k, with_cv2, monkeypatch):
    if with_cv2:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(k)
    img = rng.uniform(0.0, 10.0, (37, 53)).astype(np.float32)
    j = JSLAM(mode="mono")._gblur(img, k)
    t = TSLAM(mode="mono", device="cpu")._gblur(img, k)
    assert t.dtype == np.float32 and t.shape == img.shape
    if with_cv2:
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# retrieval
# --------------------------------------------------------------------------


def test_hamming_and_kmajority_bitwise():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    np.testing.assert_array_equal(tlc._hamming_dist(a, b), jlc._hamming_dist(a, b))
    words = jlc._kmajority(a, 40, b, np.random.default_rng(9))
    np.testing.assert_array_equal(tlc._kmajority(a, 40, b, np.random.default_rng(9)), words)
    assert not np.array_equal(words, b)  # the fit moved the words


def _orb_descriptors(n_places, seed):
    cv2 = pytest.importorskip("cv2")
    orb = cv2.ORB_create()
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_places):
        _, des = orb.detectAndCompute(_textured_place(rng, s), None)
        out.append(des)
    return out


def test_bow_retriever_matches_jax():
    """A cold start on the seeded random words, then k-majority refits as
    the descriptors grow past the train size and twice it: after every add
    the same words, trained flag and histograms; every query the same
    (id, score) list, bitwise."""
    descs = _orb_descriptors(10, 3)
    descs.insert(4, None)  # a keyframe without descriptors
    kw = dict(n_words=64, train_min_descriptors=400)
    j, t = jlc.BowRetriever(**kw), tlc.BowRetriever(**kw)
    refits = 0
    for des in descs:
        assert t.query(des) == j.query(des)
        was = j._n_des_at_train
        assert t.add(des) == j.add(des)
        refits += j._n_des_at_train != was
        assert t.trained == j.trained and len(t) == len(j)
        np.testing.assert_array_equal(t.words, j.words)
        np.testing.assert_array_equal(np.stack(t._hists), np.stack(j._hists))
    assert refits >= 2 and j.trained
    rng = np.random.default_rng(1)
    q = _perturb(_textured_place(rng, 7), rng)
    import cv2

    _, qdes = cv2.ORB_create().detectAndCompute(q, None)
    res = t.query_frame(None, qdes)
    assert res == j.query_frame(None, qdes) and res[0][0] == 8  # place 7, after the None


def test_vocabulary_quantizes_as_jax():
    """data/vocab_k10L4.txt.gz in both packages: the same tree and the same
    word for every descriptor; a pretrained retriever scores identically."""
    jv, tv = jlc.load_vocabulary(VOCAB), tlc.load_vocabulary(VOCAB)
    for name in ("children", "node_des", "leaf_word", "word_weights"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name), err_msg=name)
    assert (tv.k, tv.L, tv.n_words) == (jv.k, jv.L, jv.n_words) == (10, 4, jv.n_words)
    des = np.random.default_rng(4).integers(0, 256, (2000, 32), dtype=np.uint8)
    ids = tv.quantize(des)
    np.testing.assert_array_equal(ids, jv.quantize(des))
    assert len(np.unique(ids)) > 100
    descs = _orb_descriptors(5, 2)
    jr, tr = jlc.BowRetriever(vocabulary=jv), tlc.BowRetriever(vocabulary=tv)
    for d in descs:
        assert tr.query(d) == jr.query(d)
        assert tr.add(d) == jr.add(d)
    assert tr.query(descs[2]) == jr.query(descs[2])


def test_binary_vocabulary_round_trip_across_packages(tmp_path):
    voc = jlc.load_vocabulary(VOCAB)
    jpath, tpath = tmp_path / "j.bin", tmp_path / "t.bin"
    jlc.save_dbow_binary_vocabulary(voc, str(jpath))
    tlc.save_dbow_binary_vocabulary(tlc.load_vocabulary(VOCAB), str(tpath))
    assert jpath.read_bytes() == tpath.read_bytes()
    for loaded, ref in ((tlc.load_vocabulary(str(jpath)), voc),
                        (jlc.load_vocabulary(str(tpath)), voc)):
        for name in ("children", "node_des", "leaf_word"):
            np.testing.assert_array_equal(getattr(loaded, name), getattr(ref, name))
        np.testing.assert_allclose(loaded.word_weights, ref.word_weights, rtol=1e-6)


def test_geometry_check_matches_jax():
    cv2 = pytest.importorskip("cv2")
    orb = cv2.ORB_create()
    rng = np.random.default_rng(8)
    a = _textured_place(rng, 3)
    feats = [orb.detectAndCompute(im, None) for im in (a, _perturb(a, rng), _textured_place(rng, 4))]
    rates = []
    for i, j in ((0, 1), (0, 2), (1, 2)):
        args = (*feats[i], *feats[j])
        cv2.setRNGSeed(17)
        r_j = jsu.geometry_check(*args)
        cv2.setRNGSeed(17)
        assert tsu.geometry_check(*args) == r_j
        rates.append(r_j)
    assert rates[0] > 0.5 > rates[1]  # the revisit verifies, the other place not


def _lc_slam(cls, frame_cls, images, voc, **kw):
    cv2 = pytest.importorskip("cv2")
    slam = cls(mode="mono", **kw)
    slam.set_cam_params(80.0, 80.0, 128.0, 96.0)
    slam.enable_loop_closure(voc)
    slam.lc_min_kf_distance = 3
    slam.images_bgri = [cv2.cvtColor(i, cv2.COLOR_GRAY2BGR) for i in images]
    slam.image_loader_pt = len(images)
    slam.N_FRAMES = len(images) + 2
    slam.frames = [frame_cls(np.eye(4)) for _ in images]
    return slam


@pytest.mark.parametrize("vocabulary", ["builtin", "file"])
def test_append_kf_candidates_match_jax(vocabulary):
    """append_kf over 14 textured places and revisits of four of them: the
    same candidates, retriever state and per-frame features in both
    packages. The built-in vocabulary starts cold (stricter geometry bar)
    and refits on the way; the file vocabulary scores on its own scale."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(21)
    places = [_textured_place(rng, s) for s in range(14)]
    images = places + [_perturb(places[s], rng) for s in (1, 3, 5, 0)]
    voc = VOCAB if vocabulary == "file" else None
    j = _lc_slam(JSLAM, JFrame, images, voc)
    t = _lc_slam(TSLAM, TFrame, images, voc, device="cpu")
    assert t.lc_bow_score_thresh == j.lc_bow_score_thresh
    trained = []
    for fid in range(len(images)):
        cv2.setRNGSeed(100 + fid)
        j.append_kf(fid)
        cv2.setRNGSeed(100 + fid)
        t.append_kf(fid)
        assert t.lc_candidates == j.lc_candidates, fid
        trained.append(t.retriever.trained)
        np.testing.assert_array_equal(t.frames[fid].des, j.frames[fid].des)
    assert t.kf_ids == j.kf_ids == list(range(len(images)))
    assert {(1, 14), (3, 15), (5, 16), (0, 17)} & set(t.lc_candidates)
    if vocabulary == "builtin":
        assert not trained[0] and trained[-1]  # a cold start, then refits
        np.testing.assert_array_equal(t.retriever.words, j.retriever.words)


def test_nan_coordinates_sample_nan_in_range():
    """A point on the camera plane projects to NaN: the sample is NaN (the
    JAX package's gather clamps its index) instead of an index error."""
    img = torch.rand(6, 7, 3)
    x = torch.tensor([[1.5, float("nan"), 2.0]])
    y = torch.tensor([[float("nan"), 1.0, 2.0]])
    val, ddx, ddy = bilinear_sample_packed_grad(img[None], x, y)
    assert torch.isnan(val[0, :2]).all() and torch.isfinite(val[0, 2]).all()
    plain = bilinear_sample(img[..., 0], x[0], y[0])
    assert torch.isnan(plain[:2]).all() and torch.isfinite(plain[2])


# --------------------------------------------------------------------------
# vo_thread + mapping_thread with loop closure on
# --------------------------------------------------------------------------

LC_H, LC_W, LC_FLOWS = 128, 192, 12
LC_F = 350.0 * LC_W / 613  # the bench's field of view


def _n(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def lc_scene(h=LC_H, w=LC_W, n_flows=LC_FLOWS):
    """The bench's full-SLAM scene (bench.py:240-298: four planes, out and
    back so the last frame revisits the first, hard-edged world-anchored
    texture) at h x w and n_flows, the same path length. Returns flows,
    BGR uint8 images, gray float images, world->camera poses and K."""
    f = 350.0 * w / 613
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    planes = [(_n([0.1, 0.15, 1.0]), 8.0), (_n([-0.35, 0.1, 1.0]), 6.5),
              (_n([0.3, -0.25, 1.0]), 7.0), (_n([0.5, 0.35, 1.0]), 7.5)]
    rng = np.random.default_rng(11)
    half = n_flows // 2
    step = 0.22 * 30 / half
    poses = np.zeros((n_flows, 6), np.float32)
    for k in range(n_flows):
        poses[k, :3] = rng.normal(0, 0.002, 3)
        sign = 1.0 if k < half else -1.0
        poses[k, 3:6] = [sign * step, 0.01 * sign, 0.0]
    flows, _, Ts = render_window(
        K, poses, planes, h, w, lambda rv: so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy())
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K.astype(np.float64)).T
    bgr, gray = [], []
    for T in Ts:
        d = plane_depth(K, T[:3, :3], T[:3, 3], planes, h, w).astype(np.float64)
        Xw = (rays * d[..., None] - T[:3, 3]) @ T[:3, :3]
        t1 = np.sin(2.1 * Xw[..., 0]) * np.cos(1.7 * Xw[..., 1])
        t2 = np.sin(0.9 * Xw[..., 0] + 1.3 * Xw[..., 1] + 0.7 * Xw[..., 2])
        t3 = np.sin(3.7 * Xw[..., 0]) * np.sin(2.9 * Xw[..., 1])
        g8 = np.clip(40.0 + 75.0 * (t1 > 0) + 60.0 * (t2 > 0.3) + 45.0 * (t3 > 0.2),
                     0, 255).astype(np.uint8)
        bgr.append(np.repeat(g8[..., None], 3, axis=-1))
        gray.append(g8.astype(np.float32) / 255.0)
    return flows, bgr, gray, Ts, K


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test that runs the SLAM threads: the suite
    runs test files in parallel processes, and every process's default
    thread pool at once oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# the small map's settings: keyframe pairs three apart stay out of the
# local-link window (spatial sigma 2), so a loop closure links them, and
# the cold vocabulary's scores on ~170 ORB features sit near 0.43
LC_SETTINGS = dict(lc_min_kf_distance=3, mp_spatial_sigma=2, lc_bow_score_thresh=0.4)


def test_vo_and_mapping_threads_with_loop_closure(one_torch_thread):
    """vo_thread + mapping_thread with loop closure on (built-in
    vocabulary) over the out-and-back scene at 128x192: both threads end,
    the last keyframe's revisit becomes a candidate, its loop-closure links
    are dispatched and accepted, a global PGO follows, and the trajectory
    passes the bench's gate."""
    pytest.importorskip("cv2")
    flows, bgr, gray, Ts, K = lc_scene()
    slam = TSLAM(mode="mono", device="cpu")
    slam.voldor_user_config = "--n_poses_to_sample 2048 --depth_rand_samples 6"
    slam.set_cam_params(LC_F, LC_F, LC_W / 2, LC_H / 2)
    slam.flows = [flows[i] for i in range(LC_FLOWS)]
    slam.N_FRAMES = LC_FLOWS + 1
    slam.h, slam.w = LC_H, LC_W
    slam.flow_loader_pt = LC_FLOWS
    slam.images_bgri, slam.images_grayf = bgr, gray
    slam.image_loader_pt = LC_FLOWS + 1
    slam.enable_loop_closure()
    for k, v in LC_SETTINGS.items():
        setattr(slam, k, v)
    events = []
    slam.metrics.log = lambda event, **k: events.append(dict(event=event, **k))
    vo = threading.Thread(target=slam.vo_thread, daemon=True)
    mp = threading.Thread(target=slam.mapping_thread, daemon=True)
    vo.start()
    mp.start()
    vo.join(timeout=300)
    mp.join(timeout=300)
    assert not vo.is_alive() and not mp.is_alive()
    assert slam.lc_candidates
    lc = [e for e in events if e["event"] == "lc_link"]
    assert lc and any(e["accepted"] for e in lc)
    assert any(e.edge_type == "falign-lc" for e in slam.edges)
    names = [e["event"] for e in events]
    assert "pgo" in names[names.index("lc_link"):]
    pgo = [e for e in events if e["event"] == "pgo"]
    assert pgo[-1]["fid_start"] == 0
    gt = np.linalg.inv(Ts)
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    est = np.stack([f.Tcw for f in slam.frames]).astype(np.float64)
    assert np.isfinite(est).all()
    assert ate_rmse(est, gt, with_scale=True) < 0.02 * extent
