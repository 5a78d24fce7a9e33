"""`escgnn_tpu_torch.models.ppgn.PPGN` from its config fields; the dense
grid's side is the batch spec's, as `run_graphcount.py` sets it."""

from perfbench.systems.common import default_rule, uniform_spec

batch_spec = uniform_spec


def build(fields: dict, spec, in_dim: int, device):
    from escgnn_tpu_torch.models.ppgn import PPGN, PPGNConfig

    del in_dim
    n = max(spec.max_nodes_per_graph, spec.uniform_nodes)
    return PPGN(PPGNConfig(max_nodes=n, **fields), device=device)


def draw_rule(mod, pname: str, prm):
    """The z table N(0, 1), the rest by torch's default."""
    if pname == "z_initial":
        return ("normal", 1.0)
    return default_rule(mod, pname, prm)
