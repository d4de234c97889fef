"""Architecture registry of the port: ``--arch <id>`` resolution for
``repro_torch.launch`` and the tests.

Port of ``repro.configs``: the same eleven ids in the same order (the LM
and GNN zoo, then the five recsys tenants).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchSpec

_MODULES = {
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "dcn-v2": "repro_torch.configs.dcn_v2",
    "dien": "repro_torch.configs.dien",
    "bert4rec": "repro_torch.configs.bert4rec",
    "dlrm-uih": "repro_torch.configs.dlrm_uih",
}

# the 10 assigned archs (dlrm-uih is the paper's own, listed separately)
ASSIGNED: List[str] = [a for a in _MODULES if a != "dlrm-uih"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).spec()


def list_archs(include_paper_own: bool = True) -> List[str]:
    return list(_MODULES) if include_paper_own else list(ASSIGNED)
