"""FLOPs and kernel-boundary bytes of eager PyTorch work: the counterpart
of `escgnn_tpu/utils/hbm.py` and of the root `bench.py`'s `step_cost` and
`scan_body_bytes`.

`CostMode` is a `TorchDispatchMode` that charges every aten op it sees
by the rules XLA's `HloCostAnalysis` applies to the same op
(`jax.jit(f).lower(...).compile().cost_analysis()` on the CPU):

  * matrix products (`mm`, `addmm`, `bmm`, `baddbmm`, `convolution`;
    `linear` and `einsum` reach the mode as these): 2 FLOPs per
    multiply-add; a fused bias add counts one FLOP per output element,
    as XLA counts the add;
  * elementwise ops: one FLOP per output element (a comparison, a
    select, a convert, a min or max each count one; `threshold_backward`
    is a compare and a select, `lerp`, `addcmul` and `addcdiv` three);
    `exp`, `log`, `tanh`, `sqrt`, `rsqrt`, `erf` and a non-integer
    `pow` count one transcendental and no FLOP; an integer `pow` counts
    XLA's multiplies by squaring;
  * reductions: one FLOP per input element less one per output element
    (`mean` adds its divides, `var` counts XLA's `jnp.var`: 4 per input
    element; `argmax` XLA's variadic reduce: 9 per input element less 9
    per output);
  * composite ops (`_softmax`, `_log_softmax`, `elu`, `silu`, `gelu`,
    `sigmoid`, `native_layer_norm`, `native_batch_norm` and their
    backwards): what XLA counts for the JAX decomposition named beside
    each rule;
  * gathers count no FLOP, scatters one per source element; a sort
    n ceil(log2 n) for its n keys;
  * views, allocations and host reads (`view`, `expand`, `permute`,
    `slice`, `detach`, `empty`, `.item()`, ...) count nothing, the
    counterpart of `hbm.py`'s `_FREE_OPCODES`: the op that reads a view
    pays for the bytes;
  * `_foreach_*` ops (the optimizer's) charge each tensor of the list by
    the rule of their single-tensor op.

Bytes follow `hbm.py`'s rule at the boundary of each kernel. Without
fusion every non-view aten op is one kernel (eagerly, and as one node of
a CUDA graph captured from it), so an op is charged each tensor operand
read once and each output written once, at the operand's own size: a
broadcast view counts its distinct elements, a strided view its
elements. In-place ops read and write their destination; copies and
fills write theirs without reading it; a gather reads its indices and
the rows it gathers (not the whole table) and writes its output; a
scatter reads its indices and source and reads and writes its
destination.

The port's hand kernels (K1-K4) are charged by their wrappers through
`charge`, once per call, with the FLOPs their plain version counts under
these rules and the bytes of the kernel's own boundary (its operands
read once, its outputs written once); the wrapper's body runs inside
`kernel_scope`, where no aten op is counted, so the charge is the same
whichever version runs. XLA gives a Pallas custom call 0 FLOPs.

Where the count differs from XLA's on purpose:
  * no fusion: XLA's `bytes accessed` of a fused program and `hbm.py`'s
    boundary bytes both see fewer, larger kernels;
  * integer-to-integer converts (the int64 indices PyTorch's index ops
    take, which JAX never makes) count no FLOP; fills, `arange` and
    `eye` count none either (XLA counts iota's compares);
  * gathers and scatters count no index arithmetic (JAX's negative-index
    handling adds 3 FLOPs per index);
  * bf16 products count 2 FLOPs per multiply-add (XLA on the CPU adds
    the converts to f32 it inserts).

An op with no rule raises inside `CostMode`, naming the op: a silent 0
would drop its work from the count.

`count_cost` counts one eager train step (forward, backward, optimizer)
on a copy of a model and optimizer; `pool_load_bytes` the copies the
graphed pool step makes outside its graph before each replay.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Optional

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.data.prefetch import pool_entry


@dataclasses.dataclass
class Cost:
    """What the calls of one op (or one hand kernel) were charged."""

    calls: int = 0
    flops: int = 0
    transcendentals: int = 0
    bytes: int = 0


@dataclasses.dataclass(frozen=True)
class StepCost:
    """The totals of a counted run, and what each op contributed (by the
    op's name, `aten.<op>`, or a hand kernel's name)."""

    flops: int
    transcendentals: int
    bytes: int
    by_op: dict


# ---------------------------------------------------------------------------
# sizes
# ---------------------------------------------------------------------------


def _flat(x) -> list:
    """The tensors in an argument or an output, a list of them or None."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


def footprint(t: torch.Tensor) -> int:
    """Distinct elements a tensor addresses: a broadcast (stride 0)
    dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n if t.numel() else 0


def nbytes(*tensors) -> int:
    """Bytes of the distinct elements of each tensor, summed."""
    return sum(footprint(t) * t.element_size() for x in tensors
               for t in _flat(x))


def _numel(x) -> int:
    return sum(t.numel() for t in _flat(x))


def _io(args, kwargs, out) -> int:
    """Each tensor operand read once, each output written once."""
    ins = [a for a in args] + [v for k, v in kwargs.items() if k != "out"]
    return nbytes(*ins) + nbytes(out)


def _arg(args, kwargs, i: int, name: str, default=None):
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


def _is_index_type(dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex and (
        dtype != torch.bool)


def _convert_flops(src, dst, n: int) -> int:
    """XLA's convert: one FLOP per element, except between integer types
    (the index widening PyTorch asks for)."""
    if src == dst or (_is_index_type(src) and _is_index_type(dst)):
        return 0
    return n


# ---------------------------------------------------------------------------
# the rules: op name (in-place and _foreach_ forms map to their base op)
# -> (args, kwargs, out) -> (flops, transcendentals, bytes)
# ---------------------------------------------------------------------------

_RULES: dict = {}


def _rule(*names):
    def register(fn):
        for n in names:
            _RULES[n] = fn
        return fn
    return register


def _free(args, kwargs, out):
    return 0, 0, 0


_rule(
    # views and aliases
    "view", "_unsafe_view", "expand", "t", "transpose", "permute", "slice",
    "select", "as_strided", "squeeze", "unsqueeze", "diagonal", "detach",
    "alias", "lift_fresh",
    # allocations without a fill
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    # host reads and type queries
    "_local_scalar_dense", "promote_types",
)(_free)


def _elementwise(per_element: int):
    def rule(args, kwargs, out):
        return per_element * _numel(out), 0, _io(args, kwargs, out)
    return rule


def _transcendental(args, kwargs, out):
    return 0, _numel(out), _io(args, kwargs, out)


for _k, _names in {
    1: ("mul", "neg", "abs", "sgn", "relu", "maximum", "clamp", "clamp_min",
        "clamp_max", "eq", "ne", "lt", "le", "gt", "ge", "where",
        "bitwise_and", "bitwise_not", "isnan", "reciprocal"),
    # compare and select
    2: ("threshold_backward",),
    # lerp: a + w * (b - a); sigmoid_backward: g * y * (1 - y)
    3: ("lerp", "sigmoid_backward"),
    # jnp.remainder's rem, compares and select
    6: ("remainder",),
}.items():
    _rule(*_names)(_elementwise(_k))

_rule("exp", "log", "log1p", "tanh", "sqrt", "rsqrt", "erf")(_transcendental)


@_rule("add", "sub")
def _add(args, kwargs, out):
    # a + alpha * b: the multiply counts when alpha is not 1
    alpha = _arg(args, kwargs, 2, "alpha", 1)
    per = 1 + (alpha != 1)
    return per * _numel(out), 0, _io(args, kwargs, out)


@_rule("div")
def _div(args, kwargs, out):
    if kwargs.get("rounding_mode") is not None:
        raise NotImplementedError("CostMode: no rule for a div with a "
                                  "rounding mode")
    return _numel(out), 0, _io(args, kwargs, out)


@_rule("addcmul", "addcdiv")
def _addc(args, kwargs, out):
    # self + value * t1 (* or /) t2
    value = _arg(args, kwargs, 3, "value", 1)
    per = 2 + (isinstance(value, torch.Tensor) or value != 1)
    return per * _numel(out), 0, _io(args, kwargs, out)


@_rule("sigmoid")
def _sigmoid(args, kwargs, out):
    # XLA's logistic on the CPU: 1 / (1 + exp(-x))
    n = _numel(out)
    return 3 * n, n, _io(args, kwargs, out)


def _integer_pow_flops(e: int) -> int:
    """Multiplies of XLA's integer_pow (squaring), a divide if e < 0."""
    k = abs(e)
    if k == 0:
        return 0
    return k.bit_length() - 1 + bin(k).count("1") - 1 + (e < 0)


@_rule("pow")
def _pow(args, kwargs, out):
    n = _numel(out)
    exponent = _arg(args, kwargs, 1, "exponent")
    if isinstance(exponent, (int, float)) and not isinstance(
            args[0], (int, float)) and float(exponent).is_integer():
        return (_integer_pow_flops(int(exponent)) * n, 0,
                _io(args, kwargs, out))
    # sqrt, rsqrt or pow: one transcendental
    return 0, n, _io(args, kwargs, out)


@_rule("_to_copy", "clone", "cat", "stack", "slice_backward",
       "select_backward", "diagonal_backward")
def _copy(args, kwargs, out):
    flops = 0
    ins = _flat(args[0]) if args else []
    outs = _flat(out)
    if len(ins) == 1 and len(outs) == 1 and ins[0].shape == outs[0].shape:
        flops = _convert_flops(ins[0].dtype, outs[0].dtype, outs[0].numel())
    return flops, 0, _io(args, kwargs, out)


@_rule("copy_")
def _copy_into(args, kwargs, out):
    # dst written, src read; a convert when the types differ
    dst, src = args[0], args[1]
    return (_convert_flops(src.dtype, dst.dtype, dst.numel()), 0,
            nbytes(src) + nbytes(dst))


@_rule("zeros", "zeros_like", "new_zeros", "ones_like", "full", "full_like",
       "scalar_tensor", "eye", "arange")
def _fill(args, kwargs, out):
    return 0, 0, nbytes(out)


@_rule("fill_", "zero_")
def _fill_into(args, kwargs, out):
    return 0, 0, nbytes(args[0])


# matrix products ----------------------------------------------------------


@_rule("mm")
def _mm(args, kwargs, out):
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * b.shape[1], 0, _io(args, kwargs, out)


@_rule("bmm")
def _bmm(args, kwargs, out):
    a, b = args[0], args[1]
    return (2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], 0,
            _io(args, kwargs, out))


def _scaled_add_flops(args, kwargs, n: int) -> int:
    """The `beta * self + alpha * product` of addmm-type ops: the add, and
    a multiply for each scale that is not 1."""
    beta = _arg(args, kwargs, 3, "beta", 1)
    alpha = _arg(args, kwargs, 4, "alpha", 1)
    if beta == 0:
        return n * (alpha != 1)
    return n * (1 + (beta != 1) + (alpha != 1))


@_rule("addmm")
def _addmm(args, kwargs, out):
    a, b = args[1], args[2]
    n = out.numel()
    return (2 * a.shape[0] * a.shape[1] * b.shape[1]
            + _scaled_add_flops(args, kwargs, n), 0, _io(args, kwargs, out))


@_rule("baddbmm")
def _baddbmm(args, kwargs, out):
    a, b = args[1], args[2]
    n = out.numel()
    return (2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
            + _scaled_add_flops(args, kwargs, n), 0, _io(args, kwargs, out))


def _conv_flops(x, w, out_numel: int, transposed: bool) -> int:
    """2 per multiply-add: each output (input, transposed) element takes
    weight.shape[1] * kernel products."""
    per = w.shape[1] * math.prod(w.shape[2:])
    return 2 * (x.numel() if transposed else out_numel) * per


@_rule("convolution")
def _convolution(args, kwargs, out):
    x, w, bias = args[0], args[1], args[2]
    transposed = bool(_arg(args, kwargs, 6, "transposed", False))
    flops = _conv_flops(x, w, out.numel(), transposed)
    if bias is not None:
        flops += out.numel()
    return flops, 0, _io(args, kwargs, out)


@_rule("convolution_backward")
def _convolution_backward(args, kwargs, out):
    g, x, w = args[0], args[1], args[2]
    transposed = bool(args[7])
    mask = args[10]
    conv = _conv_flops(x, w, g.numel(), transposed)
    flops = conv * (bool(mask[0]) + bool(mask[1]))
    if mask[2]:
        flops += g.numel() - g.shape[1]
    return flops, 0, _io(args, kwargs, out)


# reductions ---------------------------------------------------------------


def _reduce_parts(args, kwargs, out):
    x = args[0]
    o = _flat(out)[0]
    return x, o, x.numel(), o.numel()


@_rule("sum", "amax")
def _reduce(args, kwargs, out):
    x, o, n, r = _reduce_parts(args, kwargs, out)
    return (n - r + _convert_flops(x.dtype, o.dtype, n), 0,
            _io(args, kwargs, out))


@_rule("max")
def _max(args, kwargs, out):
    x, o, n, r = _reduce_parts(args, kwargs, out)
    if isinstance(out, (list, tuple)):
        # max.dim: the values and, as argmax, the indices
        return 10 * (n - r), 0, _io(args, kwargs, out)
    if len(args) > 1 and isinstance(args[1], torch.Tensor):
        return o.numel(), 0, _io(args, kwargs, out)  # max.other: maximum
    return n - r, 0, _io(args, kwargs, out)


@_rule("mean")
def _mean(args, kwargs, out):
    # the sum and a divide per output
    x, o, n, r = _reduce_parts(args, kwargs, out)
    return n + _convert_flops(x.dtype, o.dtype, n), 0, _io(args, kwargs, out)


@_rule("argmax")
def _argmax(args, kwargs, out):
    # XLA's variadic (value, index) reduce: 9 per reduced element
    x, o, n, r = _reduce_parts(args, kwargs, out)
    return 9 * (n - r), 0, _io(args, kwargs, out)


@_rule("var")
def _var(args, kwargs, out):
    # jnp.var: mean, subtract, square, sum, divide
    x, o, n, r = _reduce_parts(args, kwargs, out)
    return 4 * n, 0, _io(args, kwargs, out)


@_rule("linalg_vector_norm", "norm")
def _norm(args, kwargs, out):
    x, o, n, r = _reduce_parts(args, kwargs, out)
    order = _arg(args, kwargs, 1, "ord", 2)
    if order is None or order == 2:
        # square, sum, sqrt
        return 2 * n - r, r, _io(args, kwargs, out)
    if order in (1, math.inf):
        # abs, then sum or max
        return 2 * n - r, 0, _io(args, kwargs, out)
    raise NotImplementedError(f"CostMode: no rule for a norm of order "
                              f"{order}")


# composite ops: XLA's count of the JAX decomposition named ---------------


def _rows(x: torch.Tensor, dim: int) -> int:
    return x.numel() // max(x.shape[dim], 1) if x.dim() else 1


@_rule("_softmax")
def _softmax(args, kwargs, out):
    # jax.nn.softmax: max, subtract, exp, sum, divide
    x, dim = args[0], args[1]
    n, r = x.numel(), _rows(x, dim)
    return 4 * n - 2 * r, n, _io(args, kwargs, out)


@_rule("_softmax_backward_data")
def _softmax_backward(args, kwargs, out):
    # y * (g - sum(g * y))
    g, dim = args[0], args[2]
    n, r = g.numel(), _rows(g, dim)
    return 4 * n - r, 0, _io(args, kwargs, out)


@_rule("_log_softmax")
def _log_softmax(args, kwargs, out):
    # jax.nn.log_softmax: max, subtract, exp, sum, log, subtract (and its
    # guard on the max)
    x, dim = args[0], args[1]
    n, r = x.numel(), _rows(x, dim)
    return 5 * n - 2 * r, n + r, _io(args, kwargs, out)


@_rule("_log_softmax_backward_data")
def _log_softmax_backward(args, kwargs, out):
    # g - exp(out) * sum(g)
    g, dim = args[0], args[2]
    n, r = g.numel(), _rows(g, dim)
    return 3 * n - r, n, _io(args, kwargs, out)


def _unit_factors(*values) -> int:
    return sum(v != 1 for v in values)


@_rule("elu")
def _elu(args, kwargs, out):
    # jax.nn.elu: where(x > 0, x, alpha * expm1(where(x > 0, 0, x))), one
    # multiply more per factor that is not 1
    alpha = _arg(args, kwargs, 1, "alpha", 1)
    scale = _arg(args, kwargs, 2, "scale", 1)
    input_scale = _arg(args, kwargs, 3, "input_scale", 1)
    n = args[0].numel()
    return ((3 + _unit_factors(alpha, scale, input_scale)) * n, n,
            _io(args, kwargs, out))


@_rule("elu_backward")
def _elu_backward(args, kwargs, out):
    g, alpha, scale, input_scale, is_result = args[:5]
    n = g.numel()
    if is_result:
        # where(y > 0, g, g * (y + alpha))
        return 4 * n, 0, _io(args, kwargs, out)
    # where(x > 0, g, g * alpha * exp(x))
    return ((3 + _unit_factors(alpha, scale, input_scale)) * n, n,
            _io(args, kwargs, out))


@_rule("silu")
def _silu(args, kwargs, out):
    # jax.nn.silu: x * sigmoid(x)
    n = args[0].numel()
    return 4 * n, n, _io(args, kwargs, out)


@_rule("silu_backward")
def _silu_backward(args, kwargs, out):
    # s = sigmoid(x); g * s * (1 + x * (1 - s))
    n = args[0].numel()
    return 8 * n, n, _io(args, kwargs, out)


@_rule("gelu")
def _gelu(args, kwargs, out):
    # "none": x * 0.5 * (1 + erf(x / sqrt 2)); "tanh": jax.nn.gelu's
    # approximate form
    n = args[0].numel()
    approximate = _arg(args, kwargs, 1, "approximate", "none")
    flops = 8 * n if approximate == "tanh" else 4 * n
    return flops, n, _io(args, kwargs, out)


@_rule("gelu_backward")
def _gelu_backward(args, kwargs, out):
    # "none": g * (0.5 * (1 + erf(x / sqrt 2)) + x * exp(-x^2 / 2) /
    # sqrt(2 pi)); "tanh": jax.vjp of jax.nn.gelu's approximate form
    n = args[0].numel()
    approximate = _arg(args, kwargs, 2, "approximate", "none")
    if approximate == "tanh":
        return 20 * n, n, _io(args, kwargs, out)
    return 9 * n, 2 * n, _io(args, kwargs, out)


@_rule("native_layer_norm")
def _layer_norm(args, kwargs, out):
    # m = mean(x); xc = x - m; rstd = rsqrt(mean(xc * xc) + eps);
    # xc * rstd * w + b (one multiply or add less per element for a
    # missing weight or bias)
    x, shape, w, b = args[0], args[1], args[2], args[3]
    n = x.numel()
    r = n // max(math.prod(shape), 1)
    flops = 8 * n + 3 * r - n * (w is None) - n * (b is None)
    return flops, r, _io(args, kwargs, out)


@_rule("native_layer_norm_backward")
def _layer_norm_backward(args, kwargs, out):
    # xhat = (x - m) * rstd; gx = g * w; dx = rstd / C * (C * gx -
    # sum(gx) - xhat * sum(gx * xhat)); dw = sum_rows(g * xhat); db =
    # sum_rows(g)
    g, shape = args[0], args[2]
    n = g.numel()
    c = max(math.prod(shape), 1)
    return 20 * n - n // c - 2 * c, 0, _io(args, kwargs, out)


@_rule("native_batch_norm")
def _native_batch_norm(args, kwargs, out):
    # training: m = mean(x); xc = x - m; rstd = rsqrt(mean(xc * xc) + eps);
    # xc * rstd * w + b; each running stat (1 - f) * r + f * s (the
    # variance's unbiased factor folded into f); eval: (x - rm) *
    # rsqrt(rv + eps) * w + b. One multiply or add less per element for a
    # missing weight or bias
    x, w, b, running_mean, training = args[0], args[1], args[2], args[3], args[5]
    n, c = x.numel(), x.shape[1]
    if training:
        flops = 8 * n + 3 * c + (6 * c if running_mean is not None else 0)
    else:
        flops = 4 * n + c
    flops -= n * (w is None) + n * (b is None)
    return flops, c, _io(args, kwargs, out)


@_rule("native_batch_norm_backward")
def _native_batch_norm_backward(args, kwargs, out):
    # training: xhat = (x - m) * rstd; gb = sum(g); gw = sum(g * xhat);
    # dx = w * rstd / N * (N * g - gb - xhat * gw)
    if not args[7]:
        raise NotImplementedError("CostMode: no rule for an eval-mode "
                                  "batch-norm backward")
    return 12 * args[0].numel(), 0, _io(args, kwargs, out)


# gathers and scatters -----------------------------------------------------


def _gather(index: int):
    """The indices (args[index]) and the rows gathered read, the output
    written."""
    def rule(args, kwargs, out):
        return 0, 0, nbytes(args[index]) + 2 * nbytes(out)
    return rule


_rule("index_select", "gather")(_gather(2))
_rule("embedding", "index")(_gather(1))


@_rule("index_add", "scatter_add")
def _scatter_add(args, kwargs, out):
    # the indices and source read, the destination read and written; one
    # FLOP per source element
    dst, idx, src = args[0], args[2], args[3]
    return src.numel(), 0, nbytes(idx) + nbytes(src) + 2 * nbytes(dst)


@_rule("scatter")
def _scatter_assign(args, kwargs, out):
    src = args[3] if len(args) > 3 else None
    reduce = kwargs.get("reduce", args[4] if len(args) > 4 else None)
    flops = _numel(src) if reduce is not None else 0
    return flops, 0, nbytes(args[2]) + nbytes(src) + 2 * nbytes(args[0])


@_rule("scatter_reduce")
def _scatter_reduce(args, kwargs, out):
    dst, idx, src, reduce = args[0], args[2], args[3], args[4]
    flops = src.numel() + (dst.numel() if reduce == "mean" else 0)
    return flops, 0, nbytes(idx) + nbytes(src) + 2 * nbytes(dst)


@_rule("index_put")
def _index_put(args, kwargs, out):
    dst, indices, values = args[0], args[1], args[2]
    accumulate = bool(_arg(args, kwargs, 3, "accumulate", False))
    return (values.numel() if accumulate else 0, 0,
            nbytes(indices) + nbytes(values) + 2 * nbytes(dst))


@_rule("embedding_dense_backward")
def _embedding_backward(args, kwargs, out):
    g, idx = args[0], args[1]
    return g.numel(), 0, nbytes(idx) + nbytes(g) + 2 * nbytes(out)


@_rule("sort")
def _sort(args, kwargs, out):
    # XLA's comparison sort: n ceil(log2 n) FLOPs for the n elements of
    # the keys, whichever axis; the keys read, values and indices written
    n = args[0].numel()
    return n * max(n - 1, 0).bit_length(), 0, _io(args[:1], {}, out)


# ---------------------------------------------------------------------------
# the mode
# ---------------------------------------------------------------------------


def _base_name(name: str) -> tuple:
    """(the op's rule name, whether the op is a _foreach_ op): `add_` and
    `_foreach_add_` both take the rule of `add`; `copy_`, `fill_` and
    `zero_` have their own."""
    foreach = name.startswith("_foreach_")
    if foreach:
        name = name[len("_foreach_"):]
    if name not in _RULES and name.endswith("_"):
        name = name[:-1]
    return name, foreach


def rule_for(func) -> Optional[tuple]:
    """(rule, foreach) of an op, or None when no rule covers it."""
    if func.namespace == "profiler":
        return _free, False
    if func.namespace != "aten":
        return None
    name, foreach = _base_name(func.overloadpacket.__name__)
    fn = _RULES.get(name)
    return None if fn is None else (fn, foreach)


def _foreach_cost(fn, args, kwargs, out) -> tuple:
    """A _foreach_ op: each position of its lists charged by `fn`, an
    in-place op's list its output."""
    lists = [a for a in args if isinstance(a, (list, tuple))]
    size = len(lists[0])
    outs = out if isinstance(out, (list, tuple)) else args[0]
    if not isinstance(outs, (list, tuple)):  # _foreach_pow(scalar, list)
        outs = lists[0]
    total = [0, 0, 0]
    for i in range(size):
        a = tuple(x[i] if isinstance(x, (list, tuple)) else x for x in args)
        for j, v in enumerate(fn(a, kwargs, outs[i])):
            total[j] += v
    return tuple(total)


class CostMode(TorchDispatchMode):
    """Charge every aten op run under it by the rules above (see the
    module's docstring); hand kernels charge themselves through `charge`.

        with CostMode() as mode:
            ...
        mode.total()  # StepCost

    An op no rule covers raises NotImplementedError before it runs."""

    def __init__(self):
        super().__init__()
        self.by_op: dict = {}
        self.scope_depth = 0

    def record(self, name: str, flops: int, transcendentals: int,
               nbytes_: int) -> None:
        c = self.by_op.setdefault(name, Cost())
        c.calls += 1
        c.flops += int(flops)
        c.transcendentals += int(transcendentals)
        c.bytes += int(nbytes_)

    def total(self) -> StepCost:
        return StepCost(
            flops=sum(c.flops for c in self.by_op.values()),
            transcendentals=sum(c.transcendentals
                                for c in self.by_op.values()),
            bytes=sum(c.bytes for c in self.by_op.values()),
            by_op={k: dataclasses.replace(v) for k, v in self.by_op.items()})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.scope_depth:
            return func(*args, **kwargs)
        found = rule_for(func)
        if found is None:
            raise NotImplementedError(f"CostMode: no rule for {func}")
        out = func(*args, **kwargs)
        fn, foreach = found
        if fn is not _free:
            cost = (_foreach_cost(fn, args, kwargs, out) if foreach
                    else fn(args, kwargs, out))
            self.record(f"aten.{func.overloadpacket.__name__}", *cost)
        return out


def _active() -> list:
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, CostMode)]


def active() -> bool:
    """Whether a CostMode is counting (a wrapper computes its charge only
    then)."""
    return bool(_active())


@contextlib.contextmanager
def kernel_scope():
    """A hand kernel's wrapper body: the active CostModes count none of
    its aten ops (the wrapper charges the call itself)."""
    modes = _active()
    for m in modes:
        m.scope_depth += 1
    try:
        yield
    finally:
        for m in modes:
            m.scope_depth -= 1


def charge(name: str, flops: int, transcendentals: int,
           nbytes_: int) -> None:
    """Charge one call of the hand kernel `name` to every active CostMode
    (none: nothing happens)."""
    for m in _active():
        m.record(name, flops, transcendentals, nbytes_)


# ---------------------------------------------------------------------------
# a train step, and the pool step's copies
# ---------------------------------------------------------------------------


def count_cost(model, opt, batch: GraphBatch, loss_fn) -> tuple:
    """(StepCost, loss) of one eager train step (forward, backward and the
    optimizer update) on a deep copy of `model` and `opt`, counted by
    `CostMode`: the counterpart of `bench.py`'s `step_cost`. `model` and
    `opt` are left as they were."""
    # the train loop's models sum through kernels that import this module
    from escgnn_tpu_torch.train.loop import train_step

    m, o = copy.deepcopy((model, opt))
    with CostMode() as mode:
        loss = train_step(m, o, batch, loss_fn)
    return mode.total(), float(loss)


def pool_load_bytes(pool: GraphBatch) -> int:
    """Bytes the graphed pool step moves outside its graph before each
    replay (`train/loop.py` `_PoolBuffers.load`): each field of one batch
    read from the pool and written into the step's buffer. The
    counterpart of `bench.py`'s `scan_body_bytes`, the part of a timed
    step outside the counted train step."""
    return 2 * nbytes(*pool_entry(pool, 0).tensors().values())
