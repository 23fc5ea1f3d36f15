"""Dataset loaders and splits (numpy only).

The port's own copy of ``graphsage_tpu/data/loaders.py``: for the same files
and seed it returns bit-identical arrays (tests/test_torch_data.py).

Parsers preserve the exact semantics of the reference loaders
(reference src/dataCenter.py:13-111):

- cora:   ``cora.content`` rows ``<paper_id> <1433 x 0/1> <label>`` → feature
          matrix, string→int node map in file order, label map in first-seen
          order (src/dataCenter.py:22-31); ``cora.cites`` → undirected
          adjacency (src/dataCenter.py:33-41).
- pubmed: NODE.paper.tab with 1 header line skipped, feat_map from the second
          header's ``:``-split tokens, ``label=K`` → K-1, dense TF-IDF vectors
          of width len(feat_map)-2 (src/dataCenter.py:61-72); DIRECTED.cites.tab
          with 2 headers skipped → undirected adjacency (src/dataCenter.py:77-86).
- split:  ``np.random.permutation(N)``; test = N//3, val = N//6, train = rest
          (src/dataCenter.py:100-111).

The reference's data directory is not part of this repository.  Put its
``cora/`` and ``pubmed-data/`` folders under ``data/`` at the repository root
(the default ``root``), or pass ``root``.  The big content files
(cora.content, NODE.paper.tab) are often missing from copies of it; when a
content file is absent the loader synthesizes deterministic features/labels
in the documented format so every pipeline runs end-to-end with the *real*
graph structure.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from graphsage_torch.data.graph import CSRGraph

_DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data")


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    graph: CSRGraph
    features: np.ndarray     # float32 [N, D]
    labels: np.ndarray       # int32 [N]
    num_classes: int
    train_nodes: np.ndarray  # int32
    val_nodes: np.ndarray
    test_nodes: np.ndarray
    synthetic_features: bool = False

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])


def split_nodes(num_nodes: int, seed: int,
                test_split: int = 3, val_split: int = 6):
    """Test/val/train split, reference semantics (src/dataCenter.py:100-111):
    permutation of [0, N); test = first N//3, val = next N//6, train = rest.
    ``np.random.RandomState(seed).permutation`` reproduces the reference's
    global ``np.random.seed(seed)`` + first permutation draw exactly."""
    rand_indices = np.random.RandomState(seed).permutation(num_nodes)
    test_size = num_nodes // test_split
    val_size = num_nodes // val_split
    test = rand_indices[:test_size]
    val = rand_indices[test_size:test_size + val_size]
    train = rand_indices[test_size + val_size:]
    return (test.astype(np.int32), val.astype(np.int32),
            train.astype(np.int32))


def _voronoi_labels(graph: CSRGraph, num_classes: int,
                    rng: np.random.RandomState,
                    seeds_per_class: int = 6) -> np.ndarray:
    """Topology-correlated synthetic labels via multi-source BFS Voronoi
    cells: random seed nodes get class labels, every node takes the class
    of its nearest seed.  Gives synthetic labels the edge homophily real
    citation networks have (~0.75 measured on the real Cora graph vs ~0.81
    for true Cora labels), so graph structure carries label signal and
    unsupervised/structural objectives produce meaningful downstream F1
    (purely random labels make neighborhood aggregation label-noise)."""
    n = graph.num_nodes
    labels = np.full(n, -1, np.int32)
    k = min(n, num_classes * seeds_per_class)
    seeds = rng.choice(n, k, replace=False)
    labels[seeds] = np.resize(np.arange(num_classes), k)
    frontier = [int(s) for s in seeds]
    while frontier:
        nxt: list[int] = []
        rng.shuffle(frontier)
        for v in frontier:
            for u in graph.neighbors(v):
                if labels[u] < 0:
                    labels[u] = labels[v]
                    nxt.append(int(u))
        frontier = nxt
    miss = labels < 0  # components without a seed
    labels[miss] = rng.randint(0, num_classes, int(miss.sum()))
    return labels


def _synth_features_labels(node_ids, num_feats, num_classes, seed, binary,
                           graph: CSRGraph | None = None):
    """Deterministic per-node synthetic content for when the real content
    file is absent.  Features follow the documented format
    (binary word-presence for cora per cora/README; TF-IDF floats for
    pubmed); labels are drawn so that label and a feature subset correlate,
    and — when the graph is supplied — smoothed over it so labels also
    correlate with topology, keeping every training mode informative."""
    n = len(node_ids)
    rng = np.random.RandomState(seed)
    if graph is not None:
        labels = _voronoi_labels(graph, num_classes, rng)
    else:
        labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    feats = np.zeros((n, num_feats), dtype=np.float32)
    # class-dependent signal blocks, deliberately overlapping between
    # adjacent classes and sparse (p=0.18), over a heavier uniform noise
    # floor — tuned so classifiers land in the ~0.85-0.95 micro-F1 band
    # instead of saturating at 1.0 (keeps accuracy metrics informative).
    block = max(8, num_feats // (num_classes * 4))
    stride = max(1, block // 2)
    for c in range(num_classes):
        rows = labels == c
        lo = (c * stride) % max(1, num_feats - block)
        feats[rows, lo:lo + block] = (
            rng.rand(int(rows.sum()), block) < 0.18).astype(np.float32)
    noise = rng.rand(n, num_feats) < (60.0 / num_feats)
    feats = np.maximum(feats, noise.astype(np.float32))
    if not binary:
        feats *= rng.rand(n, num_feats).astype(np.float32)
    return feats, labels


def load_cora(root: str = os.path.join(_DATA_ROOT, "cora"),
              seed: int = 824) -> Dataset:
    """Cora citation network: 2708 nodes, 1433 binary features, 7 classes
    (cora/README).  Parser semantics: reference src/dataCenter.py:14-52."""
    content_path = os.path.join(root, "cora.content")
    cites_path = os.path.join(root, "cora.cites")

    node_map: dict[str, int] = {}
    synthetic = not os.path.exists(content_path)
    if not synthetic:
        feat_rows, labels, label_map = [], [], {}
        with open(content_path) as fp:
            for i, line in enumerate(fp):
                info = line.strip().split()
                feat_rows.append([float(x) for x in info[1:-1]])
                node_map[info[0]] = i
                if info[-1] not in label_map:
                    label_map[info[-1]] = len(label_map)
                labels.append(label_map[info[-1]])
        feats = np.asarray(feat_rows, dtype=np.float32)
        labels = np.asarray(labels, dtype=np.int32)
        num_classes = len(label_map)
    else:
        # real edge file, synthesized content (documented format, cora/README)
        ids = set()
        with open(cites_path) as fp:
            for line in fp:
                a, b = line.strip().split()
                ids.add(a)
                ids.add(b)
        for i, pid in enumerate(sorted(ids, key=int)):
            node_map[pid] = i
        num_classes = 7

    src, dst = [], []
    with open(cites_path) as fp:
        for line in fp:
            info = line.strip().split()
            assert len(info) == 2
            src.append(node_map[info[0]])
            dst.append(node_map[info[1]])
    graph = CSRGraph.from_edges(len(node_map), np.array(src), np.array(dst))
    if synthetic:
        feats, labels = _synth_features_labels(
            list(node_map), num_feats=1433, num_classes=num_classes,
            seed=seed, binary=True, graph=graph)
    test, val, train = split_nodes(graph.num_nodes, seed)
    return Dataset("cora", graph, feats, labels, num_classes,
                   train, val, test, synthetic_features=synthetic)


def load_pubmed(root: str = os.path.join(_DATA_ROOT, "pubmed-data"),
                seed: int = 824) -> Dataset:
    """Pubmed-Diabetes: 3 classes, 500 TF-IDF features.  Parser semantics:
    reference src/dataCenter.py:54-97."""
    content_path = os.path.join(root, "Pubmed-Diabetes.NODE.paper.tab")
    cites_path = os.path.join(root, "Pubmed-Diabetes.DIRECTED.cites.tab")

    node_map: dict[str, int] = {}
    synthetic = not os.path.exists(content_path)
    if not synthetic:
        feat_rows, labels = [], []
        with open(content_path) as fp:
            fp.readline()
            feat_map = {e.split(":")[1]: i - 1
                        for i, e in enumerate(fp.readline().split("\t"))}
            for i, line in enumerate(fp):
                info = line.split("\t")
                node_map[info[0]] = i
                labels.append(int(info[1].split("=")[1]) - 1)
                row = np.zeros(len(feat_map) - 2, dtype=np.float32)
                for word_info in info[2:-1]:
                    k, v = word_info.split("=")
                    row[feat_map[k]] = float(v)
                feat_rows.append(row)
        feats = np.asarray(feat_rows, dtype=np.float32)
        labels = np.asarray(labels, dtype=np.int32)
    else:
        ids = []
        seen = set()
        with open(cites_path) as fp:
            fp.readline()
            fp.readline()
            for line in fp:
                info = line.strip().split("\t")
                for tok in (info[1], info[-1]):
                    pid = tok.split(":")[1]
                    if pid not in seen:
                        seen.add(pid)
                        ids.append(pid)
        for i, pid in enumerate(ids):
            node_map[pid] = i

    src, dst = [], []
    with open(cites_path) as fp:
        fp.readline()
        fp.readline()
        for line in fp:
            info = line.strip().split("\t")
            src.append(node_map[info[1].split(":")[1]])
            dst.append(node_map[info[-1].split(":")[1]])
    graph = CSRGraph.from_edges(len(node_map), np.array(src), np.array(dst))
    if synthetic:
        feats, labels = _synth_features_labels(
            ids, num_feats=500, num_classes=3, seed=seed, binary=False,
            graph=graph)
    test, val, train = split_nodes(graph.num_nodes, seed)
    return Dataset("pubmed", graph, feats, labels, 3,
                   train, val, test, synthetic_features=synthetic)


def synthetic_power_law(num_nodes: int, num_edges: int, num_feats: int = 602,
                        num_classes: int = 16, seed: int = 0,
                        alpha: float = 0.8) -> Dataset:
    """Synthetic power-law graph for scaling benchmarks (BASELINE.json
    config 5: 10M-edge power-law, edge-partitioned over hosts).

    Preferential-attachment-flavored: edge endpoints drawn from a Zipf-like
    distribution over node ids, dedup'd, undirected-ized.  Features are
    low-rank class-correlated floats so accuracy metrics remain meaningful.
    """
    rng = np.random.RandomState(seed)
    # Zipf via inverse-CDF on ranks; permute ranks so hubs are spread out
    ranks = rng.permutation(num_nodes)
    u = rng.rand(2 * num_edges)
    # p(rank r) ∝ (r+1)^-alpha  → sample via CDF table in float64
    w = (np.arange(num_nodes, dtype=np.float64) + 1.0) ** (-alpha)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    draws = np.searchsorted(cdf, u)
    endpoints = ranks[draws].reshape(2, num_edges)
    src, dst = endpoints[0], endpoints[1]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    graph = CSRGraph.from_edges(num_nodes, src, dst)

    labels = rng.randint(0, num_classes, size=num_nodes).astype(np.int32)
    basis = rng.randn(num_classes, num_feats).astype(np.float32)
    # float32 Generator path: legacy RandomState.randn materializes float64
    # (60M gaussians ≈ 90 s on slow hosts); Generator draws f32 directly
    noise_rng = np.random.default_rng(seed + 0x5EED)
    feats = basis[labels]
    feats += 0.5 * noise_rng.standard_normal((num_nodes, num_feats),
                                             dtype=np.float32)
    test, val, train = split_nodes(num_nodes, seed)
    return Dataset(f"powerlaw{num_nodes}", graph, feats, labels, num_classes,
                   train, val, test, synthetic_features=True)


def load_dataset(name: str, seed: int = 824, **kw) -> Dataset:
    """Name-dispatching loader (reference src/dataCenter.py:13 load_dataSet)."""
    if name == "cora":
        return load_cora(seed=seed, **kw)
    if name == "pubmed":
        return load_pubmed(seed=seed, **kw)
    if name.startswith("powerlaw"):
        # e.g. "powerlaw:100000:1000000"
        parts = name.split(":")
        n = int(parts[1]) if len(parts) > 1 else 100_000
        e = int(parts[2]) if len(parts) > 2 else 10 * n
        # the CLI/infer entrypoints pass root= unconditionally (a file
        # loader argument); the generator reads no files — drop it
        # instead of raising on --data_root + a synthetic dataset
        kw = {k: v for k, v in kw.items() if k != "root"}
        return synthetic_power_law(n, e, seed=seed, **kw)
    raise ValueError(f"unknown dataset {name!r}")
