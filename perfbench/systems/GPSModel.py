"""`escgnn_tpu_torch.models.gps.GPSModel` from its config fields, on the
uniform dedup blocks of `common.uniform_spec` with each graph's SPD grid
attached."""

import math

from perfbench.systems.common import default_rule, uniform_spec

# U(-b, b) with b = 0.02 * sqrt(3) has the standard deviation 0.02 of the
# port's own N(0, 0.02) draw of the SPD table
SPD_BOUND = 0.02 * math.sqrt(3.0)


def build(fields: dict, spec, in_dim: int, device):
    from escgnn_tpu_torch.models.gps import GPSConfig, GPSModel

    del spec, in_dim
    return GPSModel(GPSConfig(**fields), device=device)


def batch_spec(graphs: list, batch_size: int, layout: str):
    """Each graph's all-pairs SPD grid attached in place by the port's
    `featurize/spd.py` (`attach_attn_bias_many`, its span and counter;
    graph by graph where the port has only `attach_attn_bias`), then the
    uniform dedup blocks, whose `max_nodes_per_graph` sizes the
    (G, M, M) grid."""
    from escgnn_tpu_torch.featurize import spd

    many = getattr(spd, "attach_attn_bias_many", None)
    if many is not None:
        many(graphs)
    else:  # only a port older than `attach_attn_bias_many` comes here:
        # the same grids, graph by graph, so that it can run the cell too
        for g in graphs:
            spd.attach_attn_bias(g)
    return uniform_spec(graphs, batch_size, layout)


def draw_rule(mod, pname: str, prm):
    """Each layer's z table N(0, 1) and GINE `eps` 0; the SPD bias table
    (`self_attn.spd_bias.weight`, (102, heads)) uniform on +-0.02 sqrt(3),
    the standard deviation of the port's N(0, 0.02) draw (the benchmark
    draws only standard normals); the node and edge type embeddings,
    Linears and BatchNorms by torch's default."""
    if pname == "z_initial":
        return ("normal", 1.0)
    if pname == "eps" and prm.dim() == 0:
        return ("zeros", 0.0)
    if type(mod).__name__ == "SpdBias" and pname == "weight":
        return ("uniform", SPD_BOUND)
    return default_rule(mod, pname, prm)
