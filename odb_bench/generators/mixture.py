"""The general traffic generator: a mixture of length components, with an
optional image share, made into the port's raw records.

The lengths are stratified, not drawn: every run of ``stratum`` samples
that one rank admits in a row holds the law's ``stratum`` quantiles (each
component's at ``(i + 0.5) / k``), in an order drawn from the seed.  With
the stratum the size of the loader's grouping buffer, every buffer the
online batcher groups holds the same multiset for every seed, so a prefix
of the epoch is the same work whatever the seed; the seed changes which
identity carries which length, the order inside a stratum and the tokens.
Images go to evenly spaced members of a stratum's eligible lengths, again
the same set for every seed.

A record is what the data pipeline sees before it runs: characters of
text, chat turns and image pixels.  Characters are chosen so that the
pipeline's tokenizer model (``chars / (chars_per_token · wobble)`` with a
per-record wobble from a SHA-1 of the identity, plus the template's tokens
per turn and the visual tokens per megapixel) realizes the target length.
Nothing here calls Python's salted ``hash()``.
"""

from __future__ import annotations

import hashlib
import math
import random
from statistics import NormalDist


def unit_hash(*parts) -> float:
    """A uniform number in [0, 1) from the SHA-1 of the parts."""
    digest = hashlib.sha1("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


def wobble(identity: int, tokenizer: str) -> float:
    """The tokenizer model's per-record efficiency factor."""
    return 0.9 + 0.2 * unit_hash("tok", identity, tokenizer)


def _component_lengths(comp: dict, k: int) -> list[int]:
    lo, hi = comp["lo"], comp["hi"]
    if comp["kind"] == "lognormal":
        sigma2 = math.log(1.0 + comp["cv"] ** 2)
        mu, sigma = math.log(comp["mean"]) - sigma2 / 2.0, math.sqrt(sigma2)
        normal = NormalDist()
        raw = (math.exp(mu + sigma * normal.inv_cdf((i + 0.5) / k)) for i in range(k))
    elif comp["kind"] == "uniform":
        raw = (lo + (hi - lo) * (i + 0.5) / k for i in range(k))
    else:
        raise ValueError(f"unknown length component {comp['kind']!r}")
    return [max(lo, min(int(round(x)), hi)) for x in raw]


def _split(weights: list[float], n: int) -> list[int]:
    """n shared out by weight, largest remainders first."""
    total = sum(weights)
    exact = [w * n / total for w in weights]
    counts = [int(x) for x in exact]
    order = sorted(range(len(weights)), key=lambda i: counts[i] - exact[i])
    for i in order[: n - sum(counts)]:
        counts[i] += 1
    return counts


def target_lengths(traffic: dict, n: int) -> list[int]:
    """n target lengths, the law's quantiles, ascending."""
    comps = traffic["components"]
    out: list[int] = []
    for comp, k in zip(comps, _split([c["weight"] for c in comps], n)):
        out.extend(_component_lengths(comp, k))
    return sorted(out)


def _stratum(traffic: dict, k: int) -> list[tuple[int, bool]]:
    """A stratum of k (target length, with image) pairs, ascending."""
    lengths = target_lengths(traffic, k)
    image = traffic.get("image")
    with_image = [False] * k
    if image:
        eligible = [i for i, t in enumerate(lengths) if t > image["min_tokens"]]
        share = image["share"]
        for j, i in enumerate(eligible):
            with_image[i] = math.floor((j + 1) * share) > math.floor(j * share)
    return list(zip(lengths, with_image))


def records(traffic: dict, seed: int, streams: list[list[int]]) -> list[dict]:
    """The epoch's records, identity i at index i.  ``streams`` holds, for
    each rank, the identities in the order that rank admits them; each
    ``traffic["stratum"]`` of them in a row get one stratum, ordered by
    ``seed``."""
    size = traffic["stratum"]
    drawn: dict[int, tuple[int, bool]] = {}
    for rank, stream in enumerate(streams):
        for start in range(0, len(stream), size):
            block = stream[start:start + size]
            pairs = _stratum(traffic, len(block))
            random.Random(f"{seed}/{rank}/{start}").shuffle(pairs)
            drawn.update(zip(block, pairs))
    if sorted(drawn) != list(range(len(drawn))):
        raise ValueError("the streams must hold every identity 0..n-1 once")
    image, pipe = traffic.get("image"), traffic["pipeline"]
    out = []
    for identity in range(len(drawn)):
        target, has_image = drawn[identity]
        pixels = 0
        text = target
        if has_image:
            visual = int(target * image["token_share"])
            pixels = int(visual / pipe["visual_tokens_per_megapixel"] * 1e6)
            text = target - visual
        text_tokens = max(text - pipe["template_tokens_per_turn"], 1)
        chars = int(round(text_tokens * pipe["chars_per_token"] * wobble(identity, pipe["tokenizer"])))
        out.append({"identity": identity, "chars": max(chars, 1), "turns": 1,
                    "image_pixels": pixels, "target": target})
    return out
