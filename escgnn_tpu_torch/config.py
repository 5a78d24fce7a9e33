"""Config system (counterpart of `escgnn_tpu/config.py`): the nested
defaults tree of the GPS driver, YAML overlay, dotted command-line
overrides, and a dump of the resolved config into the run directory.

`Cfg`, `_coerce`, `DEFAULTS`, strict merging and `agg_runs` are the JAX
package's. Its YAML goes through PyYAML; this module reads and writes
YAML itself, so the port needs no PyYAML:
  * `parse_yaml` reads the subset the configs use: block mappings by
    indentation, `#` comments, plain and quoted scalars, and flow lists
    and maps of scalars (`[]`, `[0, 1]`, `{}`). Plain scalars resolve by
    PyYAML's YAML 1.1 rules (`safe_load`): `yes`/`on` are True, `~` and
    `null` are None, `0x1f` and `0o`-less `017` are ints, and a float
    needs a dot, so `1e-3` stays the string '1e-3' (which `_coerce` then
    turns into the default's float).
  * `emit_yaml` writes a resolved config that `yaml.safe_load` reads back
    to the same dict: strings that would resolve to another type are
    quoted, floats always carry a dot.
"""

from __future__ import annotations

import copy
import math
import os
import re
from typing import Any, Iterable


class Cfg(dict):
    """Dict with attribute access and strict nested merge."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def from_nested(d: dict) -> "Cfg":
        out = Cfg()
        for k, v in d.items():
            out[k] = Cfg.from_nested(v) if isinstance(v, dict) else v
        return out

    def merge(self, other: dict, path: str = "") -> None:
        """Merge `other` into self; unknown keys raise, scalar types are
        coerced to the default's type."""
        for k, v in other.items():
            full = f"{path}.{k}" if path else str(k)
            if k not in self:
                raise KeyError(f"unknown config key: {full}")
            cur = self[k]
            if isinstance(cur, Cfg):
                if not isinstance(v, dict):
                    raise TypeError(f"{full}: expected a mapping")
                cur.merge(v, full)
            else:
                self[k] = _coerce(v, cur, full)

    def to_plain(self) -> dict:
        return {
            k: (v.to_plain() if isinstance(v, Cfg) else v)
            for k, v in self.items()
        }


def _coerce(value: Any, default: Any, path: str) -> Any:
    if default is None or value is None:
        return value
    t = type(default)
    if isinstance(value, t):
        return value
    if t is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if t in (int, float):
        return t(value)
    if t is str:
        return str(value)
    if t in (list, tuple):
        return t(value)
    raise TypeError(f"{path}: cannot coerce {value!r} to {t.__name__}")


DEFAULTS = {
    "out_dir": "results/gps",
    "seed": 0,
    "run_multiple_splits": [],
    "dataset": {
        # zinc | zinc-synthetic | count_cycle | count_graphlet |
        # qm9-synthetic | mnist | cifar10 (superpixels) | aqsol |
        # vocsuperpixels | cocosuperpixels (LRGB node classification) |
        # peptides-func | peptides-struct (LRGB) |
        # ogbg-molhiv | ogbg-molpcba | ogbg-ppa | ogbg-code2 | malnet-tiny |
        # pcqm4mv2-{subset,full,inference} (OGB-LSC graph regression) |
        # pcqm4mv2contact-{shuffle,num-atoms} (inductive link prediction,
        # task: link) | ogbl-* (transductive link, task: link; one graph,
        # per-split labeled edge sets, num_graphs = synthetic node count) |
        # pattern | cluster (GNNBenchmark SBM node classification) |
        # wikipedia-{chameleon,squirrel}
        # (run_gps.build_dataset — the master_loader zoo)
        "name": "zinc-synthetic",
        "dir": "data",
        "num_graphs": 512,  # synthetic fallback size
        # regression | classification | multilabel |
        # node_classification (VOC/COCO, macro-F1) |
        # sequence (code2 sub-token heads, F1) |
        # link (inductive edge prediction, MRR + hits@k)
        "task": "regression",
        "target": 0,  # y column for counting / qm9
        "node_encoder": "embed",
        "edge_encoder": "embed",
        # ESC structural pre-transform (reference utils_escgnn.py)
        "esc": {"enable": True, "h": 3, "use_rd": True, "self_loop": True,
                "max_nodes_per_hop": 0},
        "attn_bias": True,  # all-pairs SPD matrix for biased attention
    },
    "model": {
        "type": "GPSModel",
        "dim_h": 64,
        "num_layers": 4,
        "num_heads": 4,
        "dropout": 0.0,
        "attn_dropout": 0.0,
        "local_model": "gine",  # gine | gatedgcn | pna
        # transformer | linear | performer (FAVOR+) | bigbird | san |
        # san2 | graphormer
        "global_model": "transformer",
        "san_gamma": 1e-5,
        "performer_features": 64,
        "use_equivstable_pe": False,
        "pna_towers": 4,
        "avg_deg_log": 0.0,  # 0 -> computed from the train split (pna)
        "bigbird_window": 3,
        "bigbird_global": 2,
        "bigbird_random": 2,
        "use_esc": True,
        "use_attn_bias": True,
        "use_lap_pe": False,
        "use_signnet": False,
        "use_rwse": False,
        "use_degree": False,
        "pool": "add",
        "graph_pred": True,  # False -> node-level head (counting)
        "out_dim": 1,
        "node_vocab": 100,
        "edge_vocab": 100,
    },
    "posenc": {  # featurize-time positional encodings (posenc.py)
        "lap_pe_k": 8,
        "rwse_k": 16,
    },
    "train": {
        "batch_size": 32,
        "epochs": 100,
        "eval_period": 1,
        "ckpt_period": 20,
        "ckpt_best": True,
        "auto_resume": False,
    },
    "optim": {
        "base_lr": 1e-3,
        "weight_decay": 0.0,
        "scheduler": "plateau",  # plateau | cosine | none
        "lr_decay_factor": 0.5,
        "patience": 10,
        "min_lr": 1e-5,
    },
    "metric": "mae",  # mae | accuracy | ap | auc (auc: multilabel ROC-AUC)
    "num_runs": 1,  # multi-seed aggregation (reference main.py:270)
    # finetune from a pretrained checkpoint (reference
    # GraphGPS/graphgps/config/pretrained_config.py + the loading logic
    # in main.py/custom_train): restore params from `dir`'s checkpoint,
    # optionally re-initialize the prediction head, optionally freeze
    # everything except the head
    "pretrained": {
        "dir": "",
        "reset_prediction_head": True,
        "freeze_main": False,
    },
}



# ---------------------------------------------------------------------------
# YAML 1.1 subset (PyYAML safe_load's scalar resolution)
# ---------------------------------------------------------------------------

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN)""", re.X)


def _sexagesimal(text: str, cast):
    sign = -1 if text[0] == "-" else 1
    total = 0
    for part in text.lstrip("+-").split(":"):
        total = total * 60 + cast(part)
    return sign * total


def _plain_scalar(text: str) -> Any:
    """A plain (unquoted) scalar resolved as PyYAML's SafeLoader does."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        t = text.replace("_", "")
        if ":" in t:
            return _sexagesimal(t, int)
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t == "0":
            return 0
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.fullmatch(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t.endswith(".nan"):
            return math.nan
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    return text


def _quoted(text: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at text[i] and the index after it."""
    q = text[i]
    out, j = [], i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            nxt = text[j + 1:j + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "/": "/", "0": "\0"}.get(nxt, nxt))
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _strip_comment(line: str) -> str:
    """`line` without a trailing `#` comment (a `#` that starts the line
    or follows a space, outside quotes)."""
    q = None
    for i, c in enumerate(line):
        if q:
            if c == q:
                q = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " [{,:"):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(inner: str) -> list:
    """Top-level comma-separated items of a flow collection's body."""
    items, depth, q, cur = [], 0, None, []
    for c in inner:
        if q:
            q = None if c == q else q
        elif c in "'\"":
            q = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == "," and depth == 0:
            items.append("".join(cur).strip())
            cur = []
            continue
        cur.append(c)
    tail = "".join(cur).strip()
    if tail:
        items.append(tail)
    return items


def _scalar(text: str) -> Any:
    """A node written on one line: a quoted or plain scalar, or a flow
    list / map of such nodes."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise ValueError(f"text after a quoted scalar: {text!r}")
        return value
    if text.startswith("[") and text.endswith("]"):
        return [_scalar(t) for t in _split_flow(text[1:-1])]
    if text.startswith("{") and text.endswith("}"):
        out = {}
        for item in _split_flow(text[1:-1]):
            k, _, v = item.partition(":")
            out[_scalar(k)] = _scalar(v)
        return out
    return _plain_scalar(text)


def parse_yaml(text: str) -> Any:
    """The document `text` (a block mapping nested by indentation, or one
    scalar / flow node), as `yaml.safe_load` returns it for the subset
    the configs use."""
    lines = []
    for raw in text.splitlines():
        body = _strip_comment(raw).rstrip()
        if body.strip() and body.strip() not in ("---", "..."):
            if "\t" in body[:len(body) - len(body.lstrip())]:
                raise ValueError(f"tab in indentation: {raw!r}")
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    if len(lines) == 1 and not _is_key_line(lines[0][1]):
        return _scalar(lines[0][1])
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"bad indentation at {lines[end][1]!r}")
    return value


def _is_key_line(body: str) -> bool:
    if body[:1] in ("'", '"', "[", "{"):
        return False
    return re.match(r"[^#:]*?:(\s|$)", body) is not None


def _block(lines, i: int, indent: int):
    """The block mapping whose keys sit at column `indent`, from line i;
    returns (mapping, index of the first line after it)."""
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        body = lines[i][1]
        if not _is_key_line(body):
            raise ValueError(f"expected 'key: value', got {body!r}")
        key, _, rest = body.partition(":")
        key = _scalar(key)
        if key in out:
            raise ValueError(f"duplicate key {key!r}")
        rest = rest.strip()
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i


_PLAIN_SAFE = re.compile(r"[A-Za-z_/][A-Za-z0-9_./+-]*")


def _emit_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        mant, e, exp = r.partition("e")
        if "." not in mant:
            mant += ".0"
        if e and exp[0] not in "+-":
            exp = "+" + exp
        return mant + (("e" + exp) if e else "")
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_emit_scalar(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_emit_scalar(k)}: {_emit_scalar(x)}"
                               for k, x in v.items()) + "}"
    s = str(v)
    if _PLAIN_SAFE.fullmatch(s) and _plain_scalar(s) == s:
        return s
    return "'" + s.replace("'", "''") + "'"


def emit_yaml(tree: dict, indent: int = 0) -> str:
    """Block YAML of a nested dict of scalars and lists, keys in order."""
    out = []
    for k, v in tree.items():
        pad = " " * indent
        if isinstance(v, dict) and v:
            out.append(f"{pad}{_emit_scalar(k)}:\n" + emit_yaml(v, indent + 2))
        else:
            out.append(f"{pad}{_emit_scalar(k)}: {_emit_scalar(v)}\n")
    return "".join(out)


def set_cfg() -> Cfg:
    return Cfg.from_nested(copy.deepcopy(DEFAULTS))


def load_cfg(
    yaml_path: str | None = None, opts: Iterable[str] = ()
) -> Cfg:
    """Build the resolved config: defaults <- YAML file <- dotted opts.

    `opts` come in pairs: ["optim.base_lr", "0.01", "train.epochs", "50"];
    each value is read as a YAML scalar, as the JAX package reads it.
    """
    cfg = set_cfg()
    if yaml_path:
        with open(yaml_path) as f:
            cfg.merge(parse_yaml(f.read()) or {})
    opts = list(opts)
    if len(opts) % 2:
        raise ValueError("opts must be key value pairs")
    for key, val in zip(opts[::2], opts[1::2]):
        tree: dict = {}
        cur = tree
        parts = key.split(".")
        for p in parts[:-1]:
            cur[p] = {}
            cur = cur[p]
        cur[parts[-1]] = parse_yaml(val)
        cfg.merge(tree)
    return cfg


def dump_cfg(cfg: Cfg, out_dir: str) -> None:
    """Write the resolved config into the run dir as `config.yaml`."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        f.write(emit_yaml(cfg.to_plain()))


def agg_runs(results: list[dict]) -> dict:
    """Multi-seed aggregation (reference `main.py:309` agg_runs): mean and
    std of every numeric metric across runs."""
    import numpy as np

    keys = [
        k for k, v in results[0].items() if isinstance(v, (int, float))
    ]
    agg = {}
    for k in keys:
        vals = np.asarray([r[k] for r in results], np.float64)
        agg[f"{k}_mean"] = float(vals.mean())
        agg[f"{k}_std"] = float(vals.std())
    agg["num_runs"] = len(results)
    return agg
