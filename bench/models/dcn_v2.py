"""DCN-v2 as the port trains it: the port's configuration object and its
loss over a feed batch (the model's inputs prepared on the card)."""
from __future__ import annotations

from bench.reference import dcn_v2 as reference  # noqa: F401  (by name)


def program_loss(cfg: dict):
    import torch

    from repro_torch.models import recsys as R

    pc = R.DCNv2Config(
        name=cfg["name"], n_dense=cfg["n_dense"], n_sparse=cfg["n_sparse"],
        embed_dim=cfg["embed_dim"], n_cross_layers=cfg["n_cross_layers"],
        mlp=tuple(cfg["mlp"]), field_vocab=cfg["field_vocab"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]))

    def loss_fn(params, batch):
        return R.dcn_v2_loss(params, R.dcn_v2_prep(batch, pc), pc)

    return loss_fn
