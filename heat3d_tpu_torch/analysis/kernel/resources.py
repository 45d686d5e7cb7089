"""Family kernel-resources: each instance fits the card it runs on.

The counterpart of the JAX package's ``vmem-budget`` checker. For every
kernel instance of the judged matrix it reads the dynamic shared memory,
registers a thread and resident blocks per SM through the libraries' own
queries (``ops/stencil_direct.py``, ``ops/stencil_stream.py``,
``ops/stencil_dma_fused.py`` ``instance_resources``) and the spills from
the compiler's report (``ops/_build.py`` ``ptxas_report``), and holds them
to the card's opt-in shared memory per block
(``cudaDevAttrMaxSharedMemoryPerBlockOptin``):

- ANL1041: an instance fits no SM (0 resident blocks) — error;
- ANL1042: an instance asks for more shared memory than a block may opt
  into — error;
- ANL1043: an instance spills registers to local memory — info.

``table()`` is the per-instance table ``chip_smoke.py`` prints. CUDA only.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch

from heat3d_tpu_torch.analysis.findings import ERROR, INFO, Finding

CHECKER = "kernel-resources"
_PATH = "heat3d_tpu_torch/analysis/kernel/resources.py"
_DTYPE_MANGLED = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
# (library, kernel template) of each family's compile-time instances
_TEMPLATES = {"direct": ("stencil_direct", "direct_kernel"),
              "stream": ("stencil_stream", "stream_kernel"),
              "fused": ("stencil_fused", "fused_chain_kernel")}
_T = r"(f|13__nv_bfloat16)"


def _generic_pattern(family: str, depth: int) -> str:
    """The mangled-name pattern of a family's generic kernel at ``depth``
    (``direct_generic``, ``stream_generic``, ``fused_generic``); its
    storage type is the first group."""
    return rf"{family}_genericI{_T}Li{depth}E"


def _code(case) -> int:
    """The instance code the wrapper picks for ``case``'s taps and knobs."""
    from heat3d_tpu_torch.analysis.kernel.cases import _env, taps_of
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    taps = taps_of(case.stencil)
    with _env(case.env):
        if case.family == "direct":
            return sd.direct_instance(taps)
        if case.family == "stream":
            return ss.stream_instance(taps)
        return fd.fused_instance(case.depth, taps)


def _spills(family: str, depth: int, code: int, dtype: str, bf16c: bool) -> Optional[dict]:
    """Registers and spill bytes of one instance from the compiler's
    report (every instance, generic ones too, has one of each policy)."""
    from heat3d_tpu_torch.ops import _build

    lib, kernel = _TEMPLATES[family]
    for entry, r in _build.ptxas_report(lib).items():
        if code == 0:
            m = re.search(_generic_pattern(family, depth), entry)
            if m and _DTYPE_MANGLED[m.group(1)] == dtype and ("Bf16Math" in entry) == bf16c:
                return r
            continue
        m = re.search(kernel + rf"I{_T}Li(\d)ELi(\d)E", entry)
        if (m and _DTYPE_MANGLED[m.group(1)] == dtype and int(m.group(2)) == depth
                and int(m.group(3)) == code and ("Bf16Math" in entry) == bf16c):
            return r
    return None


def table(cases: Sequence) -> List[Dict]:
    """One row per kernel instance of ``cases``: family, depth, instance,
    storage, compute, the cases that launch it, shared memory bytes,
    registers, blocks per SM, spill stores and loads (bytes); the DMA
    kernels' registers and spills from the compiler's report."""
    from heat3d_tpu_torch.analysis.kernel.cases import _DTYPES
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    query = {"direct": sd.instance_resources, "stream": ss.instance_resources,
             "fused": fd.instance_resources}
    rows, seen = [], {}
    for case in cases:
        if case.family == "dma":
            continue
        code = _code(case)
        ident = (case.family, case.depth, code, case.storage, case.compute)
        if ident in seen:
            seen[ident]["cases"].append(case.key)
            continue
        r = query[case.family](case.depth, code, _DTYPES[case.storage], _DTYPES[case.compute])
        spill = _spills(case.family, case.depth, code, case.storage,
                        case.compute == "bfloat16") or {}
        rows.append({"family": case.family, "depth": case.depth, "instance": case.instance(),
                     "code": code, "storage": case.storage, "compute": case.compute,
                     "cases": [case.key], **r, "spill_stores": spill.get("spill_stores"),
                     "spill_loads": spill.get("spill_loads")})
        seen[ident] = rows[-1]
    from heat3d_tpu_torch.ops import _build

    dma = [c.key for c in cases if c.family == "dma"]
    for entry, r in _build.ptxas_report("halo_dma").items():
        rows.append({"family": "dma", "depth": None, "instance": entry, "code": None,
                     "storage": None, "compute": None, "cases": dma, "smem_bytes": None,
                     "registers": r.get("registers"), "blocks_per_sm": None,
                     "spill_stores": r.get("spill_stores"),
                     "spill_loads": r.get("spill_loads")})
    return rows


def smem_optin(device: int = 0) -> Optional[int]:
    """The card's opt-in shared memory per block, bytes (None when the
    runtime does not say)."""
    props = torch.cuda.get_device_properties(device)
    v = getattr(props, "shared_memory_per_block_optin", None)
    return int(v) if v else None


def check(cases: Sequence, report: Dict) -> List[Finding]:
    rows = table(cases)
    limit = smem_optin()
    report["resources"] = rows
    report["smem_optin"] = limit
    findings: List[Finding] = []
    verdicts = report.setdefault("verdicts", {}).setdefault(CHECKER, {})

    def add(sev, code, row, message):
        findings.append(Finding(
            checker=CHECKER, severity=sev, path=_PATH, line=0, code=code,
            symbol=f"{row['family']}|{row['depth']}|{row['instance']}|{row['storage']}|"
                   f"{row['compute']}|{code}",
            message=message))

    for row in rows:
        what = (f"{row['family']} depth {row['depth']} {row['instance']} "
                f"{row['storage']}/{row['compute']}")
        bad = False
        if row["blocks_per_sm"] is not None and row["blocks_per_sm"] < 1:
            add(ERROR, "ANL1041", row, f"{what}: fits no SM (0 resident blocks)")
            bad = True
        if limit is not None and row["smem_bytes"] is not None and row["smem_bytes"] > limit:
            add(ERROR, "ANL1042", row, f"{what}: {row['smem_bytes']} bytes of shared memory "
                f"over the card's opt-in limit of {limit}")
            bad = True
        if (row["spill_stores"] or 0) or (row["spill_loads"] or 0):
            add(INFO, "ANL1043", row, f"{what}: spills {row['spill_stores']} bytes stored, "
                f"{row['spill_loads']} loaded ({row['registers']} registers)")
        for key in row["cases"]:
            verdicts[key] = "error" if bad else "clean"
    return findings
