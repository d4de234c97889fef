"""The reference's device benchmarks (``benchmarks/``) on the PyTorch port.

``python -m benchmarks_torch.run [--quick] [--device cpu] [filter]`` runs
them; each module's ``run(quick=..., device=...)`` returns ``BenchResult``s
with the reference's names and ``derived`` keys."""
