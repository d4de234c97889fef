"""DLRM-UIH as the port trains it: the port's configuration object and its
loss over a feed batch (the model's inputs prepared on the card)."""
from __future__ import annotations

from bench.reference import dlrm_uih as reference  # noqa: F401  (by name)


def program_loss(cfg: dict):
    import torch

    from repro_torch.models import recsys as R

    pc = R.DLRMUIHConfig(
        name=cfg["name"], seq_len=cfg["seq_len"], d_seq=cfg["d_seq"],
        n_seq_layers=cfg["n_seq_layers"], n_heads=cfg["n_heads"],
        n_dense=cfg["n_dense"], n_sparse=cfg["n_sparse"],
        embed_dim=cfg["embed_dim"], item_vocab=cfg["item_vocab"],
        field_vocab=cfg["field_vocab"], top_mlp=tuple(cfg["top_mlp"]),
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        remat=cfg["remat"], q_chunk=cfg["q_chunk"])

    def loss_fn(params, batch):
        return R.dlrm_uih_loss(params, R.dlrm_uih_prep(batch, pc), pc)

    return loss_fn
