"""Loop-closure retrieval (a copy of ``voldor_tpu/slam/loop_closure.py``;
numpy on the host, as in the JAX package).

The reference uses pyDBoW3 + a pretrained ORB vocabulary blob
(voldor_slam.py:340-359, README.md:51-54). This module provides two
interchangeable retrieval backends behind one interface:

  * BowRetriever (default): an online bag-of-binary-words database over
    ORB descriptors. Cold-starts on random binary prototypes, then LEARNS
    its vocabulary by k-majority (binary k-means with bitwise-majority
    centroids — DBoW's construction primitive) once enough descriptors
    accumulate, re-quantizing the whole database on each refit. With a
    pretrained DBoW vocabulary (``load_vocabulary``) it quantizes through
    the vocabulary tree and scores through a sparse inverted index.
  * ThumbnailRetriever: a global-descriptor prefilter — cosine similarity
    of normalized, blurred grayscale thumbnails. Cheap, vocabulary-free
    fallback when ORB descriptors are unavailable.

Either way the geometric verification stage (geometry_check: ORB +
fundamental-matrix RANSAC, slam_utils.py) does the real gating, mirroring
the reference's two-stage candidate -> geometry pipeline
(voldor_slam.py:683-701).
"""

from __future__ import annotations

import numpy as np


class ThumbnailRetriever:
    """Global-descriptor image retrieval with cosine scoring."""

    def __init__(self, thumb_size=(24, 32)):
        self.thumb_size = thumb_size
        self._db: list[np.ndarray] = []

    def _descriptor(self, image_gray: np.ndarray) -> np.ndarray:
        try:
            import cv2

            t = cv2.resize(
                image_gray, (self.thumb_size[1], self.thumb_size[0])
            ).astype(np.float32)
            t = cv2.GaussianBlur(t, (3, 3), 0)
        except ImportError:
            h, w = image_gray.shape[:2]
            sh, sw = h // self.thumb_size[0], w // self.thumb_size[1]
            t = image_gray[: sh * self.thumb_size[0], : sw * self.thumb_size[1]]
            t = t.reshape(self.thumb_size[0], sh, self.thumb_size[1], sw).mean((1, 3))
        v = t.reshape(-1)
        v = v - v.mean()
        n = np.linalg.norm(v)
        return (v / n if n > 0 else v).astype(np.float32)

    def query(self, image_gray: np.ndarray, max_results: int = 8):
        """Scores against the database WITHOUT adding. Returns a list of
        (db_index, score) sorted by descending score."""
        d = self._descriptor(image_gray)
        if not self._db:
            return []
        db = np.stack(self._db)
        scores = db @ d
        order = np.argsort(-scores)[:max_results]
        return [(int(i), float(scores[i])) for i in order]

    def add(self, image_gray: np.ndarray) -> int:
        self._db.append(self._descriptor(image_gray))
        return len(self._db) - 1

    # Uniform frame interface used by VOLDOR_SLAM.append_kf: either backend
    # picks the input it needs from (grayscale image, ORB descriptors).
    def query_frame(self, image_gray, des, max_results: int = 8):
        return self.query(image_gray, max_results)

    def add_frame(self, image_gray, des) -> int:
        return self.add(image_gray)

    def __len__(self):
        return len(self._db)


def _hamming_dist(a_packed: np.ndarray, b_packed: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distances between packed binary descriptors.

    a_packed: (A, 32) uint8, b_packed: (B, 32) uint8 -> (A, B) uint16.
    Chunked XOR + popcount over uint64 VIEWS of the packed rows (4 lanes
    per descriptor instead of 32 bytes — 8x fewer element ops than the
    uint8 path); ~33 MB scratch max.
    """
    a64 = np.ascontiguousarray(a_packed).view(np.uint64)  # (A, 4)
    b64 = np.ascontiguousarray(b_packed).view(np.uint64)  # (B, 4)
    A, B = a64.shape[0], b64.shape[0]
    out = np.zeros((A, B), np.uint16)
    # one 2-D broadcast per uint64 lane: numpy's 3-D broadcast XOR takes a
    # much slower ufunc path than the 2-D one on the same data
    chunk = max(1, (32 << 20) // max(1, B * 8))
    for s in range(0, A, chunk):
        for k in range(4):
            ak = np.ascontiguousarray(a64[s : s + chunk, k])
            out[s : s + chunk] += np.bitwise_count(
                ak[:, None] ^ b64[None, :, k]
            ).astype(np.uint16)
    return out


def _kmajority(des: np.ndarray, n_words: int, init_words: np.ndarray,
               rng: np.random.Generator, max_iters: int = 8) -> np.ndarray:
    """Binary k-means ("k-majority", the DBoW construction primitive):
    assign each descriptor to its nearest word by Hamming distance, then
    replace each word by the bitwise MAJORITY of its members. Empty
    clusters are reseeded with the descriptors farthest from their word.

    des: (T, 32) packed uint8. Returns (n_words, 32) packed uint8.
    """
    T = des.shape[0]
    # init: current words, plus random training descriptors for any slot
    # whose word never wins an assignment on the first pass
    words = init_words.copy()
    assign = np.zeros(T, np.int64)
    for _ in range(max_iters):
        dist = _hamming_dist(des, words)
        new_assign = np.argmin(dist, axis=1)
        d_min = dist[np.arange(T), new_assign].astype(np.int64)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        counts = np.bincount(assign, minlength=n_words)
        # majority update: per-cluster popular vote on each of the 256 bits.
        # One C-speed bincount per bit column — np.add.at's scatter path is
        # far slower on the same data.
        bits = np.unpackbits(des, axis=1)  # (T, 256) uint8
        sums = np.stack(
            [np.bincount(assign, weights=bits[:, j], minlength=n_words)
             for j in range(256)],
            axis=1,
        )  # (n_words, 256)
        nz = counts > 0
        maj = (sums[nz] * 2 > counts[nz, None]).astype(np.uint8)
        words[nz] = np.packbits(maj, axis=1)
        # reseed empties with the worst-fit descriptors (spreads coverage)
        n_empty = int((~nz).sum())
        if n_empty:
            far = np.argsort(-d_min)[:n_empty]
            words[~nz] = des[far]
    return words


class TreeVocabulary:
    """A pretrained DBoW2/3 vocabulary tree over binary descriptors.

    The reference loads a pretrained ORB vocabulary through pyDBoW3
    (voldor_slam.py:340-359). This class carries the same artifact —
    a k-ary tree of depth L whose leaves are the words — and performs
    the one operation retrieval needs: descriptor -> word-id quantization
    by greedy nearest-child descent (k*L Hamming comparisons instead of
    n_words, which matters at ORBvoc scale: 10^6 leaves).

    Built by `load_dbow_text_vocabulary` from the DBoW2/ORB-SLAM text
    format (`ORBvoc.txt`, optionally gzipped): header `k L scoring
    weighting`, then one node per line `parentId isLeaf b0..b31 weight`,
    nodes appended in file order under an implicit root (node 0), word
    ids assigned to leaves in file order.
    """

    def __init__(self, k: int, L: int, children: np.ndarray,
                 node_des: np.ndarray, leaf_word: np.ndarray,
                 word_weights: np.ndarray):
        self.k = k
        self.L = L
        self.children = children        # (n_nodes, k) int32, -1 = none
        self.node_des = node_des        # (n_nodes, 32) uint8
        self.leaf_word = leaf_word      # (n_nodes,) int32, -1 = not a leaf
        self.word_weights = word_weights.astype(np.float32)  # (n_words,)
        self.n_words = int(word_weights.shape[0])

    def quantize(self, des: np.ndarray) -> np.ndarray:
        """(B, 32) packed uint8 -> (B,) word ids."""
        des = np.ascontiguousarray(des, np.uint8)
        B = des.shape[0]
        cur = np.zeros(B, np.int32)  # root
        done = np.zeros(B, bool)
        for _ in range(self.L + 1):
            kids = self.children[cur]                    # (B, k)
            has_kids = kids[:, 0] >= 0
            active = ~done & has_kids
            if not active.any():
                break
            ka = kids[active]                            # (A, k)
            cand = self.node_des[np.maximum(ka, 0)]      # (A, k, 32)
            d = np.bitwise_count(
                cand ^ des[active][:, None, :]
            ).sum(-1).astype(np.int32)
            d[ka < 0] = 1 << 30                          # padded slots
            cur[active] = ka[np.arange(ka.shape[0]), np.argmin(d, axis=1)]
            done |= ~has_kids
        w = self.leaf_word[cur]
        # a malformed tree could land on an internal node; map to word 0
        return np.maximum(w, 0).astype(np.int64)


def _build_tree(k: int, L: int, parents: np.ndarray, is_leaf: np.ndarray,
                node_des_body: np.ndarray,
                weights: np.ndarray) -> TreeVocabulary:
    """Assemble a TreeVocabulary from per-node arrays (nodes in file order,
    implicit root = node 0, node ids = 1..n). Shared by the text and binary
    loaders; fully vectorized, so an ORBvoc-scale tree (~10^6 nodes) builds
    without a per-node Python loop."""
    n_body = parents.shape[0]
    n = n_body + 1
    node_ids = np.arange(1, n, dtype=np.int64)
    if np.any(parents < 0) or np.any(parents >= node_ids):
        bad = int(np.argmax((parents < 0) | (parents >= node_ids))) + 1
        raise ValueError(f"node {bad}: bad parent {int(parents[bad - 1])}")
    # per-parent child slot in file order: stable groupby-cumcount
    order = np.argsort(parents, kind="stable")
    sp = parents[order]
    first = np.concatenate([[0], np.flatnonzero(np.diff(sp)) + 1])
    slot = np.arange(n_body, dtype=np.int64)
    slot -= np.repeat(slot[first], np.diff(np.concatenate([first, [n_body]])))
    if n_body and int(slot.max()) >= k:
        p = int(sp[int(np.argmax(slot))])
        raise ValueError(f"node {p}: more than k={k} children")
    children = np.full((n, k), -1, np.int32)
    children[sp, slot] = node_ids[order].astype(np.int32)
    node_des = np.zeros((n, 32), np.uint8)
    node_des[1:] = node_des_body
    leaf_word = np.full(n, -1, np.int32)
    leaf_ids = np.flatnonzero(is_leaf)
    if leaf_ids.size == 0:
        raise ValueError("vocabulary has no leaf words")
    leaf_word[leaf_ids + 1] = np.arange(leaf_ids.size, dtype=np.int32)
    return TreeVocabulary(k, L, children, node_des, leaf_word,
                          weights[leaf_ids].astype(np.float64))


def load_dbow_text_vocabulary(path: str) -> TreeVocabulary:
    """Parse a DBoW2/ORB-SLAM text vocabulary (`ORBvoc.txt`[.gz]).

    Parsing is chunked `np.fromstring` over the raw text (every field is
    numeric), not per-line Python int(), so an ORBvoc-scale file (~10^6
    lines) parses without a per-line Python loop.
    Raises ValueError on anything that does not look like that format
    (callers fall back to the online-learned vocabulary)."""
    import gzip
    import warnings

    NF = 2 + 32 + 1  # parentId isLeaf b0..b31 weight
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        header = f.readline().split()
        if len(header) != 4:
            raise ValueError(f"not a DBoW text vocabulary header: {header!r}")
        k, L = int(header[0]), int(header[1])
        chunks = []
        tail = ""
        while True:
            block = f.read(1 << 24)
            if not block:
                break
            block = tail + block
            cut = block.rfind("\n")
            if cut < 0:
                tail = block
                continue
            tail, body = block[cut + 1:], block[:cut]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                vals = np.fromstring(body, dtype=np.float64, sep=" ")
            if vals.size:
                chunks.append(vals)
        if tail.strip():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                chunks.append(np.fromstring(tail, dtype=np.float64, sep=" "))
    flat = np.concatenate(chunks) if chunks else np.zeros(0)
    if flat.size % NF != 0:
        raise ValueError(
            f"vocabulary body is not a multiple of {NF} fields "
            f"({flat.size} values)"
        )
    rows = flat.reshape(-1, NF)
    parents = rows[:, 0].astype(np.int64)
    is_leaf = rows[:, 1] != 0
    descs = rows[:, 2:34]
    if np.any(descs < 0) or np.any(descs > 255):
        raise ValueError("descriptor bytes out of [0, 255]")
    return _build_tree(k, L, parents, is_leaf, descs.astype(np.uint8),
                       rows[:, 34])


def load_dbow_binary_vocabulary(path: str) -> TreeVocabulary:
    """Parse a DBoW2 *binary* vocabulary (`ORBvoc.bin`) — the de-facto
    format of the ORB-SLAM2 `loadFromBinaryFile` forks that the reference
    ecosystem distributes pretrained ORB vocabularies in (pyDBoW3 loads
    the same artifact, voldor_slam.py:340-359).

    Layout (little-endian): header `uint32 nb_nodes, uint32 size_node,
    int32 k, int32 L, int32 scoring, int32 weighting`, then `nb_nodes`
    fixed-size records `int32 parent | desc[size_node-9] bytes |
    float32 weight | uint8 is_leaf` (for ORB descriptors size_node = 41).
    Nodes are in file order under the implicit root (node 0); word ids
    are assigned to leaves in file order — identical tree semantics to
    the text format, so both share `_build_tree`."""
    with open(path, "rb") as f:
        head = f.read(24)
        if len(head) != 24:
            raise ValueError("file too short for a DBoW binary header")
        nb_nodes, size_node = np.frombuffer(head[:8], np.uint32)
        k, L, _scoring, _weighting = np.frombuffer(head[8:], np.int32)
        if not (0 < k < 1024 and 0 < L < 32 and 9 < size_node < 4096):
            raise ValueError(
                f"implausible DBoW binary header (k={k} L={L} "
                f"size_node={size_node})")
        d_len = int(size_node) - 9
        if d_len != 32:
            raise ValueError(
                f"descriptor length {d_len} != 32 (ORB) — unsupported")
        body = np.frombuffer(f.read(int(nb_nodes) * int(size_node)),
                             np.uint8)
    if body.size != int(nb_nodes) * int(size_node):
        raise ValueError("truncated DBoW binary body")
    rec = body.reshape(int(nb_nodes), int(size_node))
    parents = rec[:, 0:4].copy().view(np.int32).reshape(-1).astype(np.int64)
    descs = rec[:, 4:4 + d_len]
    weights = rec[:, 4 + d_len:8 + d_len].copy().view(np.float32).reshape(-1)
    is_leaf = rec[:, 8 + d_len] != 0
    return _build_tree(int(k), int(L), parents, is_leaf, descs,
                       weights.astype(np.float64))


def save_dbow_binary_vocabulary(voc: TreeVocabulary, path: str,
                                scoring: int = 0, weighting: int = 0):
    """Write `voc` in the ORBvoc.bin layout load_dbow_binary_vocabulary
    reads (round-trip partner; also converts text vocabularies to the
    ~6x smaller binary form). Children are emitted in slot order, so
    file order — and therefore word-id assignment — is preserved across
    a save/load cycle."""
    n = voc.node_des.shape[0]
    # file order = node id order (ids 1..n-1 were assigned in file order)
    parents = np.zeros(n, np.int32)
    for p in range(n):
        kids = voc.children[p]
        parents[kids[kids >= 0]] = p
    leaf = voc.leaf_word >= 0
    weights = np.zeros(n, np.float32)
    weights[leaf] = voc.word_weights[voc.leaf_word[leaf]]
    rec = np.zeros((n - 1, 41), np.uint8)
    rec[:, 0:4] = parents[1:, None].view(np.uint8).reshape(-1, 4)
    rec[:, 4:36] = voc.node_des[1:]
    rec[:, 36:40] = weights[1:, None].view(np.uint8).reshape(-1, 4)
    rec[:, 40] = leaf[1:]
    with open(path, "wb") as f:
        f.write(np.asarray([n - 1, 41], np.uint32).tobytes())
        f.write(np.asarray([voc.k, voc.L, scoring, weighting],
                           np.int32).tobytes())
        f.write(rec.tobytes())


def load_vocabulary(path: str) -> TreeVocabulary:
    """Load a pretrained DBoW vocabulary, sniffing text vs binary: `.bin`
    (or a binary header that parses) -> load_dbow_binary_vocabulary,
    otherwise the text loader. This is the single entry point
    VOLDOR_SLAM.enable_loop_closure uses."""
    p = str(path)
    if p.endswith(".bin"):
        return load_dbow_binary_vocabulary(p)
    if p.endswith((".txt", ".txt.gz", ".gz", ".yml", ".yaml")):
        return load_dbow_text_vocabulary(p)
    try:
        return load_dbow_binary_vocabulary(p)
    except ValueError:
        return load_dbow_text_vocabulary(p)


class BowRetriever:
    """Online bag-of-binary-words with TF-IDF scoring over ORB descriptors.

    Cold start uses fixed random binary prototypes (stable across runs).
    Once enough descriptors accumulate, the vocabulary is LEARNED from them
    by incremental k-majority (binary k-means with bitwise-majority centroid
    updates — the same primitive DBoW3 vocabularies are built from), and the
    whole database is re-quantized under the new words. Retraining repeats
    each time the descriptor count grows by `retrain_growth`x, so the
    vocabulary tracks the actual appearance distribution of the sequence
    instead of random Hamming-space directions (voldor_slam.py:340-359's
    pretrained ORBvoc plays this role in the reference).
    """

    def __init__(self, n_words: int = 512, seed: int = 233,
                 train_min_descriptors: int | None = None,
                 retrain_growth: float = 2.0,
                 max_train_descriptors: int = 8192,
                 vocabulary: TreeVocabulary | None = None):
        rng = np.random.default_rng(seed)
        self._rng = rng
        # A pretrained TreeVocabulary (DBoW ORBvoc) replaces both the
        # random cold-start words and the online k-majority fit: the tree
        # quantizes, the file's weights serve as idf, trained is True from
        # frame 0 (no cold-start schedule applies).
        self._voc = vocabulary
        if vocabulary is not None:
            n_words = vocabulary.n_words
            self.words = None
            self.trained = True
        else:
            self.words = rng.integers(
                0, 256, size=(n_words, 32), dtype=np.uint8
            )
            self.trained = False  # True after the first k-majority fit
        self.n_words = n_words
        self._hists: list[np.ndarray] = []
        self._df = np.zeros(n_words if vocabulary is None else 0, np.float64)
        # Pretrained-vocabulary store: a dense (n_words,) histogram per
        # keyframe is ~4 MB at ORBvoc scale (10^6 words) and the dense
        # np.stack(...) per query would transfer hundreds of MB — instead
        # frames keep SPARSE (word_ids, idf-weighted vals) postings plus an
        # inverted index word -> [(frame, weighted val)], the same
        # accumulation scheme DBoW2 queries with. idf is fixed (the file's
        # weights), so per-frame weighted norms cache at add time.
        self._n_frames = 0
        self._inv: dict[int, list[tuple[int, float]]] = {}
        self._wnorms: list[float] = []
        # raw descriptors per frame, kept packed for re-quantization
        self._frame_des: list[np.ndarray | None] = []
        self._n_des_total = 0
        self._n_des_at_train = 0
        self._train_min = train_min_descriptors or 4 * n_words
        self._retrain_growth = retrain_growth
        self._max_train = max_train_descriptors

    def _hist(self, des: np.ndarray | None) -> np.ndarray:
        if des is None or len(des) == 0:
            return np.zeros(self.n_words, np.float32)
        dist = _hamming_dist(np.asarray(des, np.uint8), self.words)
        assign = np.argmin(dist, axis=1)
        h = np.bincount(assign, minlength=self.n_words).astype(np.float32)
        n = np.linalg.norm(h)
        return h / n if n > 0 else h

    def _sparse_hist(self, des: np.ndarray | None):
        """(word_ids int64[], idf-weighted vals float32[]) for the
        pretrained-vocabulary path; vals are the file's-weight-scaled,
        count-L2-normalized term frequencies."""
        if des is None or len(des) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        assign = self._voc.quantize(np.asarray(des, np.uint8))
        ids, counts = np.unique(assign, return_counts=True)
        vals = counts.astype(np.float32)
        vals /= np.linalg.norm(vals)
        return ids, vals * self._voc.word_weights[ids].astype(np.float32)

    def _maybe_train(self) -> bool:
        """Fit/refit the vocabulary when enough descriptors accumulated.
        Returns True if it retrained (and therefore rebuilt `_hists`/`_df`
        for EVERY frame currently in `_frame_des`, including one appended
        just before the call — the caller must not append again)."""
        if self._voc is not None:  # pretrained vocabulary is fixed
            return False
        if self._n_des_total < self._train_min:
            return False
        if self.trained and (
            self._n_des_total < self._retrain_growth * self._n_des_at_train
        ):
            return False
        pool = [d for d in self._frame_des if d is not None and len(d)]
        if not pool:
            return False
        des = np.concatenate(pool, axis=0)
        if des.shape[0] > self._max_train:
            sel = self._rng.choice(des.shape[0], self._max_train, replace=False)
            des = des[sel]
        self.words = _kmajority(
            des, self.words.shape[0], self.words, self._rng
        )
        self.trained = True
        self._n_des_at_train = self._n_des_total
        # re-quantize the whole database under the new vocabulary
        self._hists = [self._hist(d) for d in self._frame_des]
        self._df = np.zeros(self.words.shape[0], np.float64)
        for h in self._hists:
            self._df += h > 0
        return True

    def query(self, des: np.ndarray | None, max_results: int = 8):
        if self._voc is not None:
            # pretrained vocabulary: inverted-index accumulation (DBoW2's
            # query scheme) — cost scales with the query's posting lists,
            # not with n_words x n_frames. The file's word weights ARE the
            # idf (DBoW TF_IDF weighting over its training corpus — stable
            # from keyframe 0, unlike the db-derived df below).
            if self._n_frames == 0:
                return []
            ids, qw = self._sparse_hist(des)
            qn = float(np.linalg.norm(qw))
            if qn <= 0:
                return []
            acc: dict[int, float] = {}
            for wid, qv in zip(ids.tolist(), qw.tolist()):
                for fidx, v in self._inv.get(wid, ()):
                    acc[fidx] = acc.get(fidx, 0.0) + qv * v
            if not acc:
                return []
            frames = np.fromiter(acc.keys(), np.int64, len(acc))
            dots = np.fromiter(acc.values(), np.float64, len(acc))
            norms = np.asarray([self._wnorms[f] for f in frames])
            scores = dots / (qn * np.maximum(norms, 1e-9))
            order = np.argsort(-scores)[:max_results]
            return [(int(frames[i]), float(scores[i])) for i in order]
        h = self._hist(des)
        if not self._hists:
            return []
        # smoothed (always-positive) idf: plain log((1+N)/(1+df)) zeroes
        # every word with df==N, which in a small database (first few
        # keyframes) is MOST words — scores then ride on rare noise words
        # and an exact revisit can score ~0.35. log1p keeps common words
        # at reduced weight so the score scale is stable across db sizes.
        idf = np.log1p(
            (1 + len(self._hists)) / (1 + self._df)
        ).astype(np.float32)
        db = np.stack(self._hists) * idf
        qv = h * idf
        qn = np.linalg.norm(qv)
        scores = db @ (qv / qn if qn > 0 else qv)
        norms = np.linalg.norm(db, axis=1)
        scores = scores / np.maximum(norms, 1e-9)
        order = np.argsort(-scores)[:max_results]
        return [(int(i), float(scores[i])) for i in order]

    def add(self, des: np.ndarray | None) -> int:
        if des is not None and len(des):
            des = np.ascontiguousarray(des, np.uint8)
            self._n_des_total += des.shape[0]
        else:
            des = None
        if self._voc is not None:
            fidx = self._n_frames
            ids, vals = self._sparse_hist(des)
            for wid, v in zip(ids.tolist(), vals.tolist()):
                self._inv.setdefault(wid, []).append((fidx, v))
            self._wnorms.append(float(np.linalg.norm(vals)))
            self._n_frames += 1
            return fidx
        self._frame_des.append(des)
        if not self._maybe_train():
            # no retrain: quantize just this frame. (A retrain rebuilds the
            # whole database including this frame — appending here too would
            # duplicate it and shift every later index.)
            h = self._hist(des)
            self._hists.append(h)
            self._df += h > 0
        return len(self._hists) - 1

    # Uniform frame interface (see ThumbnailRetriever.query_frame). A frame
    # with no usable descriptors (detectAndCompute returned None) gets a
    # zero histogram: it stays index-aligned in the database but can never
    # match — image_gray is intentionally NOT used as a fallback signal
    # here (mixing descriptor spaces would corrupt TF-IDF scoring; use
    # ThumbnailRetriever when descriptors are unavailable).
    def query_frame(self, image_gray, des, max_results: int = 8):
        return self.query(des, max_results)

    def add_frame(self, image_gray, des) -> int:
        return self.add(des)

    def __len__(self):
        return self._n_frames if self._voc is not None else len(self._hists)
