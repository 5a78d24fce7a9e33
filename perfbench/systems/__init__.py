"""Adapters, one per model class of `escgnn_tpu_torch`, found by the
configuration's `model.system`. `perfbench/systems/<model>.py` exposes

  build(fields, spec, in_dim, device) -> torch.nn.Module
  batch_spec(graphs, batch_size, layout) -> the system's BatchSpec
  draw_rule(module, name, param) -> (kind, bound) or None

`draw_rule` names how `perfbench/weights.py` draws a parameter: "uniform"
on (-bound, bound), "normal" (standard), "ones" or "zeros". `common.py`
holds what several adapters share."""
