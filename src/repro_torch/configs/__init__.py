"""Architecture registry of the port: ``--arch <id>`` resolution for
``repro_torch.launch`` and the tests.

Port of ``repro.configs``. The five recsys tenants are registered; the LM
and GNN ids of the reference's registry belong to the zoo slice, and asking
for one raises a ``KeyError`` that says so.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchSpec

_MODULES = {
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "dcn-v2": "repro_torch.configs.dcn_v2",
    "dien": "repro_torch.configs.dien",
    "bert4rec": "repro_torch.configs.bert4rec",
    "dlrm-uih": "repro_torch.configs.dlrm_uih",
}

# the reference registry's LM and GNN ids, ported with the model zoo
ZOO = ("qwen3-8b", "qwen3-4b", "granite-8b", "qwen3-moe-30b-a3b",
       "deepseek-v2-lite-16b", "meshgraphnet")

# the assigned archs (dlrm-uih is the paper's own, listed separately)
ASSIGNED: List[str] = [a for a in _MODULES if a != "dlrm-uih"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in ZOO:
        raise KeyError(f"arch {arch_id!r} is an LM/GNN model; the port "
                       f"registers it with the model-zoo slice "
                       f"(transformer/moe/gnn), not yet ported")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).spec()


def list_archs(include_paper_own: bool = True) -> List[str]:
    return list(_MODULES) if include_paper_own else list(ASSIGNED)
