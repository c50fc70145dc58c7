"""Three-term roofline from the dry run's per-device counts.

    compute term    = flops      / peak FLOP/s
    memory term     = hbm_bytes  / HBM rate
    collective term = coll_bytes / link rate

All three inputs are per device: ``flops`` and ``hbm_bytes`` from
:func:`repro_torch.roofline.cost.count` on the local program, the
collective bytes from the sharding rules (``launch/dryrun.py``); there is no
compiled program to parse.

Hardware constants: NVIDIA H100 SXM5 80GB at its 700 W limit, from the
data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s per direction
of NVLink 4.  A mesh axis that crosses nodes runs over the network, which
is slower than NVLink, so the collective term is optimistic there.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # dense bf16 per card
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # bytes/s per direction, NVLink 4


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per device, counted (the JAX field name is kept)
    hlo_bytes: float  # per device
    coll_bytes: float  # per device
    model_flops: float  # 6·N_active·D analytic, per device
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: a remat/redundancy waste detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU upper bound: useful-compute time / bound time."""
        ideal = self.model_flops / PEAK_FLOPS  # per-device ideal step time
        return ideal / self.bound_time_s if self.bound_time_s else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for_cell(cfg, cell, n_active: int | None = None) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference fwd), D = tokens."""
    n = n_active if n_active is not None else cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * cell.global_batch


def roofline_from_artifacts(
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    parsed: dict,  # per-device totals: flops, hbm_bytes, coll_bytes
    model_flops_global: float,
) -> RooflineTerms:
    flops = float(parsed.get("flops", 0.0))
    byts = float(parsed.get("hbm_bytes", 0.0))
    cbytes = float(parsed.get("coll_bytes", 0.0))
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=flops,
        hlo_bytes=byts,
        coll_bytes=cbytes,
        model_flops=model_flops_global / chips,
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=cbytes / LINK_BW,
    )
