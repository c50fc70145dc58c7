"""Synthetic corpora with the paper's length statistics (App. I).

Two families:

  * the six 1000-sample synthetic distributions used for correctness audits
    (App. I): uniform-narrow U[64,512], uniform-wide U[64,2048],
    longtail (90% short / 10% long), bimodal (50/50), all-long U[1800,2048],
    all-short U[32,64];

  * clones of the public datasets' *length distributions* (Table 10):
      UltraChat-200K  N=207,865  mean≈1196  CV=0.48  max 4,471  text
      LLaVA-150K      N=157,712  mean≈508   CV=0.29  max 1,260  multimodal
      ShareGPT4o      N= 57,284  mean≈1494  CV=1.00  max 12,110 multimodal
      MM-Mix          N=272,589  CV≈0.8 bimodal, f_s≈0.37       multimodal
    generated as RawRecords whose realized lengths (through the online
    pipeline) match the target (mean, CV, max).  Dataset sizes are scalable
    (``scale``) so tests run in seconds while benchmarks can use larger N.

We clone length *distributions*, not content: ODB's behaviour is a pure
function of realized lengths, world size and knobs, so distribution clones
reproduce the batching-system operating points exactly.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable

from repro_torch.data.pipeline import PipelinePolicy, RawRecord, realize_lengths


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    size: int
    policy: PipelinePolicy
    make_records: Callable[[int, int], list[RawRecord]]  # (size, seed) -> records
    target_cv: float | None = None
    multimodal: bool = False

    def records(self, seed: int = 0) -> list[RawRecord]:
        return self.make_records(self.size, seed)

    def lengths(self, seed: int = 0, epoch: int = 0) -> list[int]:
        return realize_lengths(self.records(seed), self.policy, epoch)


# ---------------------------------------------------------------------------
# Six synthetic audit distributions (App. I).
# ---------------------------------------------------------------------------


def _records_from_lengths(lengths: list[int]) -> list[RawRecord]:
    """Invert the (augmentation-free) pipeline so realized lengths match.

    With strength=0 the pipeline maps chars -> tokens deterministically per
    identity; we solve chars for the desired token count.
    """
    from repro_torch.data.pipeline import _unit_hash

    records = []
    policy = PipelinePolicy()
    for i, target in enumerate(lengths):
        wobble = 0.9 + 0.2 * _unit_hash("tok", i, policy.tokenizer)
        text_target = max(target - policy.template_tokens_per_turn, 1)
        chars = int(round(text_target * policy.chars_per_token * wobble))
        records.append(RawRecord(identity=i, chars=max(chars, 1), turns=1))
    return records


def _synthetic(name: str, gen: Callable[[random.Random], int], size: int = 1000):
    def make(size_: int, seed: int) -> list[RawRecord]:
        rng = random.Random((name, seed).__hash__() & 0x7FFFFFFF)
        return _records_from_lengths([gen(rng) for _ in range(size_)])

    return DatasetSpec(
        name=name, size=size, policy=PipelinePolicy(cutoff_len=4096), make_records=make
    )


SYNTHETIC_DISTRIBUTIONS = {
    "uniform_narrow": _synthetic("uniform_narrow", lambda r: r.randint(64, 512)),
    "uniform_wide": _synthetic("uniform_wide", lambda r: r.randint(64, 2048)),
    "longtail": _synthetic(
        "longtail",
        lambda r: r.randint(32, 256) if r.random() < 0.9 else r.randint(1024, 4000),
    ),
    "bimodal": _synthetic(
        "bimodal",
        lambda r: r.randint(64, 160) if r.random() < 0.5 else r.randint(1200, 2048),
    ),
    "all_long": _synthetic("all_long", lambda r: r.randint(1800, 2048)),
    "all_short": _synthetic("all_short", lambda r: r.randint(32, 64)),
}


# ---------------------------------------------------------------------------
# Public dataset length-distribution clones (Table 10).
# ---------------------------------------------------------------------------


def _lognormal_lengths(
    rng: random.Random, n: int, mean: float, cv: float, lo: int, hi: int
) -> list[int]:
    sigma2 = math.log(1.0 + cv * cv)
    mu = math.log(mean) - sigma2 / 2.0
    sigma = math.sqrt(sigma2)
    out = []
    for _ in range(n):
        l = int(round(math.exp(rng.gauss(mu, sigma))))
        out.append(max(lo, min(l, hi)))
    return out


def _clone(name, size, mean, cv, lo, hi, cutoff, multimodal=False):
    def make(size_: int, seed: int) -> list[RawRecord]:
        rng = random.Random((name, seed).__hash__() & 0x7FFFFFFF)
        lengths = _lognormal_lengths(rng, size_, mean, cv, lo, hi)
        records = _records_from_lengths(lengths)
        if multimodal:
            # Shift ~35% of tokens into image patches for a third of samples
            # (keeps total length; makes lengths depend on visual expansion).
            out = []
            policy = PipelinePolicy(cutoff_len=cutoff)
            for rec, tgt in zip(records, lengths):
                if rng.random() < 0.33 and tgt > 128:
                    img_tokens = int(tgt * 0.35)
                    pixels = int(img_tokens / policy.visual_tokens_per_megapixel * 1e6)
                    txt_tokens = tgt - img_tokens
                    txt = _records_from_lengths([txt_tokens])[0]
                    out.append(
                        RawRecord(
                            identity=rec.identity,
                            chars=txt.chars,
                            turns=1,
                            image_pixels=pixels,
                        )
                    )
                else:
                    out.append(rec)
            records = out
        return records

    return DatasetSpec(
        name=name,
        size=size,
        policy=PipelinePolicy(cutoff_len=cutoff),
        make_records=make,
        target_cv=cv,
        multimodal=multimodal,
    )


DATASET_CLONES = {
    "ultrachat": _clone("ultrachat", 207_865, 1196.0, 0.48, 16, 4471, 8192),
    "llava": _clone("llava", 157_712, 508.0, 0.29, 32, 1260, 2048, multimodal=True),
    "sharegpt4o": _clone(
        "sharegpt4o", 57_284, 1494.0, 1.00, 16, 12_110, 16_384, multimodal=True
    ),
}


def _make_mmmix(size_: int, seed: int) -> list[RawRecord]:
    # Bimodal production mix (App. I): 45% short OCR/VQA labels, 30% mid
    # VQA/caption, 25% long-form captioning; calibrated to CV≈0.85.
    rng = random.Random(("mmmix", seed).__hash__() & 0x7FFFFFFF)
    lengths = []
    for _ in range(size_):
        u = rng.random()
        if u < 0.45:  # short OCR / VQA labels
            lengths.append(rng.randint(32, 480))
        elif u < 0.75:  # mid VQA / short captions
            lengths.append(rng.randint(480, 2200))
        else:  # long-form captioning / dialogue
            lengths.append(int(_lognormal_lengths(rng, 1, 2400, 0.30, 800, 12_110)[0]))
    return _records_from_lengths(lengths)


DATASET_CLONES["mmmix"] = DatasetSpec(
    name="mmmix",
    size=272_589,
    policy=PipelinePolicy(cutoff_len=16_384),
    make_records=_make_mmmix,
    target_cv=0.80,
    multimodal=True,
)


def get_dataset(name: str, scale: float = 1.0) -> DatasetSpec:
    """Fetch a dataset spec, optionally scaled down (same distribution)."""
    table = {**SYNTHETIC_DISTRIBUTIONS, **DATASET_CLONES}
    if name not in table:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(table)}")
    spec = table[name]
    if scale == 1.0:
        return spec
    return dataclasses.replace(spec, size=max(int(spec.size * scale), 8))
