"""`escgnn_tpu_torch.models.nested_gin_eff.NestedGINEff` from its config
fields."""

from perfbench.systems.common import default_rule, uniform_spec

batch_spec = uniform_spec


def build(fields: dict, spec, in_dim: int, device):
    from escgnn_tpu_torch.models.nested_gin_eff import (
        NestedGINEff,
        NestedGINEffConfig,
    )

    return NestedGINEff(NestedGINEffConfig(**fields), in_dim=in_dim,
                        device=device)


def draw_rule(mod, pname: str, prm):
    """The z table N(0, 1), each GINE layer's scalar `eps` 0, the rest by
    torch's default."""
    if pname == "z_initial":
        return ("normal", 1.0)
    if pname == "eps" and prm.dim() == 0:
        return ("zeros", 0.0)
    return default_rule(mod, pname, prm)
