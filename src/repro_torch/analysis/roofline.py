"""Roofline analysis over the dry run's artifacts (``launch/dryrun.py``),
the reference's ``src/repro/analysis/roofline.py`` against an NVIDIA
H100 instead of a TPU.

Hardware model: NVIDIA H100 SXM5, 700 W, the published peaks of its
data sheet (NVIDIA H100 Tensor Core GPU data sheet): 989 TFLOP/s dense
bfloat16 per card (``PEAK_FLOPS``), 3.35 TB/s of HBM3 (``HBM_BW``) and
NVLink 4 at 900 GB/s per card, 450 GB/s each way (``NVLINK_BW``). These
are published peaks, not measurements.

Per (arch x shape x mesh) cell, three terms in seconds:

  compute    = global FLOPs / (cards * peak)
               global FLOPs from the traced step (every layer traced,
               so no scan correction; ``corrected.flops_global``).
  memory     = per-card HBM traffic / HBM bandwidth
               traffic model: resident argument bytes read once per step
               (weights + optimizer state + KV cache) + 2x the trace's
               temporary bytes (write + read), both per position.
  collective = per-card collective bytes / NVLink's bandwidth each way
               from the port's exchange points, all-reduce counted 2x
               (ring). A (16, 16) mesh spans 256 cards, more than one
               NVLink domain (8 cards in an HGX H100 board) holds, so
               taking NVLink's rate everywhere makes this term a lower
               bound.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per train step
(3 matmul passes), 2·N·D for prefill, 2·N_active·(new tokens) for
decode: the useful-compute yardstick of the MODEL_FLOPS / traced-FLOPs
ratio.
"""
from __future__ import annotations

import glob
import json
from dataclasses import dataclass
from pathlib import Path

PEAK_FLOPS = 989e12  # dense bfloat16 / card
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s each way per card

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,        # one new token per sequence
    "long_500k": 1,
}


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    bound: str
    step_s: float
    roofline_frac: float
    note: str = ""

    def as_dict(self):
        return self.__dict__.copy()


def model_flops(d: dict) -> float:
    """6·N_active·D train, 2·N_active·D inference (MoE-aware), from the
    original (unpadded) parameter count, so padding shows in the
    ratio."""
    tokens = SHAPE_TOKENS[d["shape"]]
    n = d["params_orig"]
    n_active = min(d.get("params_active") or n, n)
    mult = 6.0 if d["kind"] == "train" else 2.0
    return mult * n_active * tokens


def analyze(d: dict) -> RooflineRow:
    chips = d["n_devices"]
    hlo_flops = (d.get("corrected") or {}).get("flops_global") or 0.0
    compute_s = hlo_flops / (chips * PEAK_FLOPS)

    mem = d["memory"]
    resident = (mem.get("argument_bytes") or 0)
    temp = (mem.get("temp_bytes") or 0)
    traffic = resident + 2.0 * temp  # read args once; write+read temps
    memory_s = traffic / HBM_BW

    coll = d.get("collectives") or {}
    coll_bytes = sum(v for k, v in coll.items() if k != "_counts")
    collective_s = coll_bytes / NVLINK_BW

    mf = model_flops(d)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    step_s = max(terms.values())
    # the ideal step: compute for train/prefill, streaming the resident
    # bytes (weights + KV cache) for decode
    ideal_s = max(mf / (chips * PEAK_FLOPS), resident / HBM_BW)
    frac = min(ideal_s / step_s if step_s > 0 else 0.0, 1.0)
    return RooflineRow(
        arch=d["arch"], shape=d["shape"], mesh=d["mesh"], chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, hlo_flops=hlo_flops, bound=bound, step_s=step_s,
        roofline_frac=frac,
    )


def load_all(art_dir: str = "artifacts/dryrun", mesh: str = "single"
             ) -> list[RooflineRow]:
    rows = []
    for f in sorted(glob.glob(f"{art_dir}/*__{mesh}.json")):
        d = json.loads(Path(f).read_text())
        rows.append(analyze(d))
    return rows


def table(rows: list[RooflineRow]) -> str:
    hdr = (f"{'arch':<18} {'shape':<12} {'compute':>10} {'memory':>10} "
           f"{'collect':>10} {'bound':>10} {'MODEL/HLO':>10} "
           f"{'roofline%':>10}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        ratio = r.model_flops / r.hlo_flops if r.hlo_flops else 0.0
        lines.append(
            f"{r.arch:<18} {r.shape:<12} {r.compute_s:>10.4f} "
            f"{r.memory_s:>10.4f} {r.collective_s:>10.4f} {r.bound:>10} "
            f"{ratio:>10.3f} {100*r.roofline_frac:>9.1f}%")
    return "\n".join(lines)

