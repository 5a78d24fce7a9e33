"""ogbg-code2-shaped AST dataset (synthetic stand-in; a copy of
`escgnn_tpu/data/code2.py`).

The reference's GraphGPS fork loads ogbg-code2 through
`master_loader.py:411-434`: Python-method ASTs whose target is the
sequence of sub-tokens of the method name (max_seq_len = 5 over a
5000-token vocabulary + special EOS/UNK), with `augment_edge` adding
next-token + inverse edges and `encode_y_to_arr` mapping the token list
to a fixed (L,) int array. The node features are (type-id, depth) pairs
consumed by the ASTNodeEncoder (`encoder/ast_encoder.py`: type embedding
+ depth embedding).

The real dataset needs the `ogb` package, which the port does not use;
this generator reproduces the SHAPES and a learnable signal: random trees
whose token sequence is a deterministic function of tree statistics, so
the sequence heads actually train. Vocabulary ids: [0, vocab) real
tokens, `vocab` = EOS, `vocab + 1` = UNK (the OGB convention).
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

MAX_SEQ_LEN = 5
NUM_VOCAB = 64  # synthetic vocabulary (the real one is 5000)
NUM_NODE_TYPES = 98  # ogb code2 AST node-type count
MAX_DEPTH = 20


def eos_id() -> int:
    return NUM_VOCAB


def unk_id() -> int:
    return NUM_VOCAB + 1


def synthetic_code2(
    num_graphs: int = 400, seed: int = 0
) -> list[GraphData]:
    """Random ASTs: x = (n, 2) int [type, depth], directed tree edges
    (parent -> child) plus inverse edges (the reference's augment_edge
    inverse direction; edge_attr column 0 = direction flag), y =
    (MAX_SEQ_LEN,) int token array padded with EOS."""
    rng = np.random.default_rng(seed + 13)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(15, 60))
        parent = np.zeros(n, np.int64)
        depth = np.zeros(n, np.int64)
        for v in range(1, n):
            parent[v] = int(rng.integers(0, v))
            depth[v] = min(depth[parent[v]] + 1, MAX_DEPTH - 1)
        types = rng.integers(0, NUM_NODE_TYPES, n).astype(np.int64)
        a = np.arange(1, n)
        p = parent[1:]
        # parent->child then inverse child->parent (augment_edge)
        ei = np.concatenate(
            [np.stack([p, a]), np.stack([a, p])], axis=1
        ).astype(np.int32)
        ea = np.concatenate(
            [np.zeros(n - 1, np.int32), np.ones(n - 1, np.int32)]
        )[:, None]
        # learnable token sequence from tree statistics
        stats = [
            int(depth.max()),
            int(np.bincount(parent[1:], minlength=n).max()),
            int(types.sum() % NUM_VOCAB),
            int(n),
        ]
        L = int(rng.integers(1, MAX_SEQ_LEN + 1))
        y = np.full(MAX_SEQ_LEN, eos_id(), np.int64)
        for i in range(L):
            y[i] = (stats[i % 4] + 3 * i) % NUM_VOCAB
        x = np.stack([types, depth], axis=1)
        out.append(GraphData(
            num_nodes=n, edge_index=ei, x=x.astype(np.int32),
            edge_attr=ea, y=y.astype(np.float32),
        ))
    return out


def code2_splits(
    data_dir: str, num_graphs: int = 400, seed: int = 0
) -> tuple[dict, bool]:
    """Synthetic 80/10/10 splits (the real loader needs the `ogb`
    package — same caveat as the other OGB rows)."""
    raw = synthetic_code2(num_graphs=num_graphs, seed=seed)
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }, False


def subtoken_f1(pred_tokens: np.ndarray, true_tokens: np.ndarray) -> float:
    """OGB code2 metric: per-graph F1 between predicted and true token
    SEQUENCES truncated at the first EOS, averaged over graphs
    (duplicates kept, position-free — the OGB evaluator compares
    multisets via precision/recall of the token lists)."""
    f1s = []
    for p, t in zip(pred_tokens, true_tokens):
        def trunc(seq):
            toks = []
            for s in seq:
                if int(s) == eos_id():
                    break
                toks.append(int(s))
            return toks

        pl, tl = trunc(p), trunc(t)
        if not pl and not tl:
            f1s.append(1.0)
            continue
        common = 0
        tl_pool = list(tl)
        for tok in pl:
            if tok in tl_pool:
                tl_pool.remove(tok)
                common += 1
        prec = common / len(pl) if pl else 0.0
        rec = common / len(tl) if tl else 0.0
        f1s.append(
            0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec)
        )
    return float(np.mean(f1s)) if f1s else 0.0
