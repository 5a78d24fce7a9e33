"""PCQM4Mv2Contact-shaped inductive link-prediction dataset (a copy of
`escgnn_tpu/data/contact.py`).

Capability mirror of the reference's molecular-contact link task
(`GraphGPS/graphgps/loader/master_loader.py:236-237,527-557` +
`GraphGPS/graphgps/loader/dataset/pcqm4mv2_contact.py`): per-graph
inductive edge prediction — given a molecular graph, predict which
long-range atom pairs are in 3D contact. Each graph carries

  * ``extras["pair_index"]`` (2, P) int32 — labeled candidate pairs
    (the reference's ``edge_index_labeled``), positives first;
  * ``extras["pair_label"]`` (P,) float32 in {0, 1} (``edge_label``).

The real dataset is built from cxsmiles with rdkit-extracted contact
annotations (pcqm4mv2_contact.py:22-46) — neither rdkit nor network
egress exists in this environment, so (following the repo's
real-if-present loader pattern) `contact_splits` loads a preprocessed
per-split cache when one is on disk and otherwise generates the
synthetic stand-in below.

Synthetic stand-in: molecule-like graphs dominated by a BACKBONE PATH
(think residue chain) with short-span side chords; a positive contact
is every backbone pair at index distance exactly `contact_distance`
(the contact-map shape of the real task). The rule is a fixed
function of pairwise backbone offset, which a dot-product decoder can
represent exactly through cosine node features (LapPE eigenvectors of
a path are cosines), so a working GPS+LapPE pipeline must beat the
random-ranking MRR by a wide margin and a broken one cannot.

Negative sampling follows the reference's structured transform
(`structured_neg_sampling_transform`, pcqm4mv2_contact.py:191-214):
for each positive (i, j), `num_neg_per_pos` uniform tail corruptions
(i, k), k != j, self-loops allowed. Sampled ONCE at generation time
with the dataset rng (the reference resamples per epoch when
`cfg.dataset.resample_negative`; with device-resident pools the
static sample is the deliberate simplification — eval never uses the
sampled negatives, it ranks against ALL nodes).
"""

from __future__ import annotations

import os

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

_ATOM_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
_BOND_DIMS = (5, 6, 2)


def _contact_graph(rng, n: int, contact_distance: int,
                   num_neg_per_pos: int) -> GraphData:
    src = list(range(n - 1)) + list(range(1, n))
    dst = list(range(1, n)) + list(range(n - 1))
    # short-span side chords (ring closures) — molecule-like decoration
    for _ in range(int(rng.integers(1, max(2, n // 6)))):
        a = int(rng.integers(0, n - 3))
        b = a + int(rng.integers(2, 4))
        if b < n:
            src += [a, b]
            dst += [b, a]
    ei = np.stack([np.asarray(src), np.asarray(dst)]).astype(np.int32)
    # dedupe (chords may repeat)
    key = ei[0].astype(np.int64) * n + ei[1]
    _, keep = np.unique(key, return_index=True)
    ei = ei[:, np.sort(keep)]
    x = np.stack(
        [rng.integers(0, min(d, 16), n) for d in _ATOM_DIMS], axis=1
    ).astype(np.int32)
    ea = np.stack(
        [rng.integers(0, d, ei.shape[1]) for d in _BOND_DIMS], axis=1
    ).astype(np.int32)
    heads = np.arange(0, n - contact_distance, dtype=np.int32)
    pos = np.stack([
        np.concatenate([heads, heads + contact_distance]),
        np.concatenate([heads + contact_distance, heads]),
    ])
    P = pos.shape[1]
    neg_heads = np.repeat(pos[0], num_neg_per_pos)
    neg_tails = rng.integers(
        0, n, size=P * num_neg_per_pos
    ).astype(np.int32)
    # k != j: re-draw collisions with the true tail (one pass + clip is
    # enough at these sizes; a residual collision only weakens a
    # negative, never corrupts a positive)
    true_tails = np.repeat(pos[1], num_neg_per_pos)
    coll = neg_tails == true_tails
    neg_tails[coll] = (neg_tails[coll] + 1) % n
    pair_index = np.concatenate(
        [pos, np.stack([neg_heads, neg_tails])], axis=1
    ).astype(np.int32)
    pair_label = np.concatenate(
        [np.ones(P, np.float32), np.zeros(P * num_neg_per_pos, np.float32)]
    )
    return GraphData(
        num_nodes=n, edge_index=ei, x=x, edge_attr=ea,
        y=np.zeros(1, np.float32),  # unused placeholder (loss reads pairs)
        extras={"pair_index": pair_index, "pair_label": pair_label},
    )


def synthetic_contact(
    num_graphs: int = 1000,
    seed: int = 0,
    contact_distance: int = 5,
    num_neg_per_pos: int = 2,
) -> list[GraphData]:
    rng = np.random.default_rng(seed)
    return [
        _contact_graph(
            rng, int(rng.integers(14, 30)), contact_distance,
            num_neg_per_pos,
        )
        for _ in range(num_graphs)
    ]


def contact_splits(
    data_dir: str,
    split: str = "shuffle",
    num_graphs: int = 1000,
    seed: int = 0,
) -> tuple[dict, bool]:
    """(splits, is_real). `split`: 'shuffle' (random 80/10/10) or
    'num-atoms' (the reference's inductive size split: train on the
    smallest molecules, test on the largest —
    pcqm4mv2_contact.py get_idx_split('num-atoms')).

    Real-if-present: `<data_dir>/pcqm4mv2contact/raw/<split_name>.npz`
    per-split files in the featurize-cache layout
    (`featurize/cache.py save_graphs`) are loaded directly."""
    assert split in ("shuffle", "num-atoms"), split
    raw_dir = os.path.join(data_dir, "pcqm4mv2contact", "raw")
    paths = {s: os.path.join(raw_dir, f"{s}.npz")
             for s in ("train", "val", "test")}
    if all(os.path.exists(p) for p in paths.values()):
        from escgnn_tpu_torch.featurize.cache import load_graphs

        return {s: load_graphs(p) for s, p in paths.items()}, True
    graphs = synthetic_contact(num_graphs=num_graphs, seed=seed)
    if split == "num-atoms":
        graphs = sorted(graphs, key=lambda g: g.num_nodes)
    n_tr, n_val = int(0.8 * len(graphs)), int(0.1 * len(graphs))
    return {
        "train": graphs[:n_tr],
        "val": graphs[n_tr:n_tr + n_val],
        "test": graphs[n_tr + n_val:],
    }, False


def synthetic_ogbl(
    num_nodes: int = 600,
    seed: int = 0,
    dim: int = 8,
    num_neg_per_pos: int = 2,
) -> dict:
    """ogbl-* -shaped TRANSDUCTIVE link prediction (reference
    master_loader.py:224-235: `load_ogb('ogbl-…')` with
    train/val/test_edge_label splits on ONE graph).

    A dot-product random graph: latent z_i ~ N(0, I_d)/sqrt(d), edges
    sampled w.p. sigmoid(4·z_i·z_j − 1) — so dot-decoded node
    embeddings are exactly the right hypothesis class and a working
    pipeline must beat random ranking by a wide margin. Positive edges
    split 80/10/10 into per-split labeled pairs with
    `num_neg_per_pos` uniform tail corruptions each; the message-
    passing graph carries TRAIN positives only (the standard ogbl
    protocol — val/test edges are never seen by propagation)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(num_nodes, dim)) / np.sqrt(dim)
    logits = 8.0 * (z @ z.T) - 7.0  # avg degree ~12 at n=600 (collab-like)
    prob = 1.0 / (1.0 + np.exp(-logits))
    upper = np.triu(rng.random((num_nodes, num_nodes)) < prob, k=1)
    a, b = np.nonzero(upper)
    order = rng.permutation(len(a))
    a, b = a[order], b[order]
    n_tr = int(0.8 * len(a))
    n_val = int(0.1 * len(a))
    groups = {
        "train": (a[:n_tr], b[:n_tr]),
        "val": (a[n_tr:n_tr + n_val], b[n_tr:n_tr + n_val]),
        "test": (a[n_tr + n_val:], b[n_tr + n_val:]),
    }
    # message-passing edges: symmetrized TRAIN positives
    ta, tb = groups["train"]
    ei = np.stack([
        np.concatenate([ta, tb]), np.concatenate([tb, ta]),
    ]).astype(np.int32)
    # node features: noisy linear view of the latent positions (real
    # ogbl-collab ships 128-dim word embeddings that are likewise
    # informative of link structure); node_encoder "linear" recovers
    # embeddings from them — the pipeline is tested on
    # features -> embeddings -> dot ranking, not on memorizing ids
    x = (z + 0.25 * rng.normal(size=z.shape)).astype(np.float32)
    out = {}
    for split, (pa, pb) in groups.items():
        pos = np.stack([
            np.concatenate([pa, pb]), np.concatenate([pb, pa]),
        ]).astype(np.int32)
        P = pos.shape[1]
        neg_heads = np.repeat(pos[0], num_neg_per_pos)
        neg_tails = rng.integers(
            0, num_nodes, size=P * num_neg_per_pos
        ).astype(np.int32)
        true_tails = np.repeat(pos[1], num_neg_per_pos)
        coll = neg_tails == true_tails
        neg_tails[coll] = (neg_tails[coll] + 1) % num_nodes
        pair_index = np.concatenate(
            [pos, np.stack([neg_heads, neg_tails])], axis=1
        ).astype(np.int32)
        pair_label = np.concatenate([
            np.ones(P, np.float32),
            np.zeros(P * num_neg_per_pos, np.float32),
        ])
        out[split] = [GraphData(
            num_nodes=num_nodes, edge_index=ei, x=x,
            edge_attr=np.zeros(ei.shape[1], np.int32),
            y=np.zeros(1, np.float32),
            extras={"pair_index": pair_index, "pair_label": pair_label},
        )]
    return out


def ogbl_splits(
    data_dir: str,
    name: str = "ogbl-collab",
    num_nodes: int = 600,
    seed: int = 0,
) -> tuple[dict, bool]:
    """(splits, is_real). Real-if-present:
    `<data_dir>/<name with _>/raw/<split>.npz` per-split files in the
    featurize-cache layout (graph + pair extras); otherwise
    `synthetic_ogbl`."""
    import os

    raw_dir = os.path.join(data_dir, name.replace("-", "_"), "raw")
    paths = {s: os.path.join(raw_dir, f"{s}.npz")
             for s in ("train", "val", "test")}
    if all(os.path.exists(p) for p in paths.values()):
        from escgnn_tpu_torch.featurize.cache import load_graphs

        return {s: load_graphs(p) for s, p in paths.items()}, True
    return synthetic_ogbl(num_nodes=num_nodes, seed=seed), False
