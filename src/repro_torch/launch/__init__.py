"""Launch layer of the port: meshes, placements, (arch x shape) cells,
their sampled inputs and the fake-mesh dry run (``repro.launch``'s twin)."""
