"""Roofline of a traced step, the JAX package's ``repro/core/roofline.py``
with H100 constants.  It takes ``core.export.cost(module)`` (FLOPs and
bytes of the traced step's ops, the kernels' from their bound
interiors) and the traced module (``core.export.module_from_graph``) in
the place of ``compiled.cost_analysis()`` and HLO text, and reports the
three terms per (arch x shape x mesh) cell:

    compute    = FLOPs / peak FLOP/s           (per card)
    memory     = bytes / HBM bandwidth         (per card)
    collective = collective wire bytes / link bandwidth  (per card)

A traced sharded step is one rank's program, so its FLOPs and bytes are
per card, as the reference's partitioned cost analysis is.  The
collectives are the step's ``repro_torch::`` collective nodes, priced by
``structure.collective_bytes``'s ring model, unchanged.

The constants are an H100 SXM's (``core.sampling``: 989e12 bf16 FLOP/s
dense, 3.35e12 B/s HBM3, 450e9 B/s NVLink each way), not the TPU v5e's
of the reference.  NVLink joins the 8 cards of one node: a ``model``
axis wider than 8 ranks crosses nodes, where the link is slower, so the
collective term is a lower bound there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.sampling import HBM_BW, ICI_BW, PEAK_FLOPS
from repro_torch.core.structure import HloModule, collective_bytes


@dataclasses.dataclass
class RooflineReport:
    name: str
    mesh: str
    chips: int
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    coll_operand_bytes: float
    coll_wire_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_total: float
    bytes_per_dev: Dict[str, float]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """The largest term: the step's time with every term overlapped
        perfectly (a lower bound); the terms stay visible."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs over every card: remat, padding and
        masked work."""
        total = self.hlo_flops_per_dev * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Roofline-model MFU: useful model FLOPs / (cards x peak x
        step_time)."""
        denom = self.chips * PEAK_FLOPS * self.step_time
        return self.model_flops_total / denom if denom else 0.0

    @property
    def roofline_fraction(self) -> float:
        """How close the dominant term pins the step to its roof; for a
        compute-bound step, MFU."""
        if self.dominant == "compute":
            return self.mfu
        return (self.t_compute / self.step_time) if self.step_time else 0.0

    def row(self) -> dict:
        return {
            "name": self.name, "mesh": self.mesh, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops_total,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "hlo_bytes_per_dev": self.hlo_bytes_per_dev,
            "coll_operand_bytes_per_dev": self.coll_operand_bytes,
            "coll_wire_bytes_per_dev": self.coll_wire_bytes,
            "useful_ratio": self.useful_ratio,
            "mfu_model": self.mfu,
            "step_time_s": self.step_time,
        }


def analyze(name: str, mesh_desc: str, chips: int, cost: Dict[str, float],
            module: HloModule, model_flops_total: float = 0.0,
            peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
            ici_bw: float = ICI_BW) -> RooflineReport:
    """The roofline of one traced step: ``cost`` is
    ``core.export.cost(module)``.  The reference scales XLA's cost
    analysis by its while loops' trip counts (``HloModule.cost_scale``);
    the traced graph is unrolled (one computation, no while), so the
    scale here is 1."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(module)
    return RooflineReport(
        name=name, mesh=mesh_desc, chips=chips,
        hlo_flops_per_dev=flops,
        hlo_bytes_per_dev=nbytes,
        coll_operand_bytes=coll["operand_bytes"],
        coll_wire_bytes=coll["wire_bytes"],
        t_compute=flops / peak_flops,
        t_memory=nbytes / hbm_bw,
        t_collective=coll["wire_bytes"] / ici_bw,
        model_flops_total=model_flops_total,
        bytes_per_dev={k: v for k, v in coll.items()
                       if k.startswith("operand_bytes/")},
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS convention: 6*N*D for training (N = params, D = tokens;
    active params for MoE), 2*N*D for prefill, 2*N_active*B per decoded
    token."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def markdown_table(rows) -> str:
    cols = ["name", "mesh", "chips", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "model_flops",
            "useful_ratio", "mfu_model", "step_time_s"]
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join(["---"] * len(cols)) + "|"]
    for r in rows:
        vals = []
        for c in cols:
            v = r[c] if isinstance(r, dict) else getattr(r, c)
            vals.append(f"{v:.3e}" if isinstance(v, float) else str(v))
        out.append("| " + " | ".join(vals) + " |")
    return "\n".join(out)
