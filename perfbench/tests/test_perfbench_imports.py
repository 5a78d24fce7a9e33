"""No file of the benchmark imports JAX or the JAX package (module names
compared by their whole top-level name: `escgnn_tpu_torch` is not
`escgnn_tpu`), and no file of the reference imports the system."""

import ast
import os

from perfbench import cell

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "escgnn_tpu"}
HERE = os.path.join(cell.ROOT, "perfbench")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {(p, m) for p in _files(HERE) for m in _imports(p)
             if m in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_system():
    found = {(p, m) for p in _files(os.path.join(HERE, "reference"))
             for m in _imports(p) if m in FORBIDDEN | {"escgnn_tpu_torch"}}
    assert not found


def test_whole_name_comparison():
    assert cell.forbidden_modules(["escgnn_tpu_torch.models.ppgn",
                                   "numpy"]) == []
    assert cell.forbidden_modules(["escgnn_tpu.featurize", "jax.numpy",
                                   "optax"]) == ["escgnn_tpu", "jax",
                                                 "optax"]
