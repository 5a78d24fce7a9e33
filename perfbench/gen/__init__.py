"""Traffic generators: `perfbench/gen/<name>.py` exposes
`generate(params, seed, workers) -> list[RawGraph]`, and a traffic file
names its generator by `<name>`."""
