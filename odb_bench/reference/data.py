"""What the data path should deliver, worked out from the benchmark's
records alone, and the check of what it did deliver.

A record's realized length is the pipeline's deterministic model (no
augmentation): text tokens chars / (chars_per_token · wobble), plus the
chat template's tokens per turn, plus the image's visual tokens per
megapixel, rounded and clipped to [1, cutoff].  A sample's tokens are the
benchmark's, drawn from (seed, identity).  Every delivered segment has to
be one record's tokens, whole and in order, at its realized length, with
positions from 0, the loss mask on it and nothing but padding around it;
the step's accounting has to count it; and no record may come twice in
the epoch (Theorem 1 in join mode, as far as a prefix of the epoch shows
it).
"""

from __future__ import annotations

import numpy as np

from odb_bench.generators.mixture import wobble


def realized_length(rec: dict, pipe: dict, cutoff: int) -> int:
    text = rec["chars"] / (pipe["chars_per_token"] * wobble(rec["identity"], pipe["tokenizer"]))
    visual = rec["image_pixels"] / 1.0e6 * pipe["visual_tokens_per_megapixel"]
    total = int(round(text + rec["turns"] * pipe["template_tokens_per_turn"] + visual))
    return max(1, min(total, cutoff))


def sample_tokens(seed: int, identity: int, length: int, vocab: int) -> np.ndarray:
    return np.random.default_rng([seed, identity]).integers(1, vocab, size=length, dtype=np.int32)


def segments_of(row_segments: np.ndarray) -> list:
    """[(start, end)] of the maximal runs of one non-zero segment id."""
    seg = np.asarray(row_segments)
    cuts = np.flatnonzero(np.diff(seg) != 0) + 1
    bounds = np.concatenate([[0], cuts, [len(seg)]]).tolist()
    return [(s, e) for s, e in zip(bounds[:-1], bounds[1:]) if seg[s] != 0]


class DataCheck:
    """Holds the records' expected samples; ``step`` checks one delivered
    step and returns the identities it delivered and, rank 0 first, the
    records' own tokens of each as (rank, tokens): what the reference
    trains on is the benchmark's, in the grouping the program chose."""

    def __init__(self, records, pipe: dict, cutoff: int, seed: int, vocab: int):
        self.lengths = [realized_length(r, pipe, cutoff) for r in records]
        self.tokens = [sample_tokens(seed, r["identity"], n, vocab)
                       for r, n in zip(records, self.lengths)]
        self.by_prefix = {tuple(t[:3]): i for i, t in enumerate(self.tokens)}
        self.faults: list[str] = []

    def fault(self, what: str) -> None:
        if len(self.faults) < 1000:
            self.faults.append(what)
        else:
            self.faults[-1] = f"... and more ({what})"

    def step(self, index: int, ranks: list, samples_per_rank, tokens_per_rank) -> tuple:
        """``ranks`` = per-rank dicts of (rows, T) arrays ``tokens``,
        ``positions``, ``segments``, ``loss_mask``."""
        ids, samples = [], []
        for r, b in enumerate(ranks):
            n_tok = n_samp = 0
            for row in range(b["tokens"].shape[0]):
                seg = b["segments"][row]
                spans = segments_of(seg)
                covered = np.zeros(len(seg), dtype=bool)
                for s, e in spans:
                    covered[s:e] = True
                    toks = b["tokens"][row, s:e]
                    ident = self.by_prefix.get(tuple(toks[:3]))
                    where = f"step {index} rank {r} row {row} [{s}, {e})"
                    if ident is None:
                        self.fault(f"{where}: tokens of no record")
                        continue
                    if e - s != self.lengths[ident]:
                        self.fault(f"{where}: record {ident} of length {self.lengths[ident]} "
                                   f"delivered with {e - s} tokens")
                    elif not np.array_equal(toks, self.tokens[ident]):
                        self.fault(f"{where}: record {ident}'s tokens altered")
                    if not np.array_equal(b["positions"][row, s:e], np.arange(e - s)):
                        self.fault(f"{where}: positions do not run 0..{e - s - 1}")
                    if not np.all(b["loss_mask"][row, s:e] == 1):
                        self.fault(f"{where}: loss mask off inside the sample")
                    ids.append(ident)
                    samples.append((r, self.tokens[ident]))
                    n_tok += e - s
                    n_samp += 1
                pad = ~covered
                if np.any(b["loss_mask"][row][pad] != 0) or np.any(b["tokens"][row][pad] != 0):
                    self.fault(f"step {index} rank {r} row {row}: padding carries tokens or loss")
            if n_tok != tokens_per_rank[r] or n_samp != samples_per_rank[r]:
                self.fault(f"step {index} rank {r}: accounting says {samples_per_rank[r]} samples, "
                           f"{tokens_per_rank[r]} tokens; delivered {n_samp}, {n_tok}")
        return ids, samples

    def at_most_once(self, ids: list) -> None:
        """A prefix of a join-mode epoch: no view of a record twice (the
        epoch is a whole number of views a rank, so no padding views)."""
        counts = np.bincount(np.asarray(ids, dtype=np.int64), minlength=len(self.lengths))
        if np.any(counts > 1):
            self.fault(f"{int(np.sum(counts > 1))} records delivered more than once, "
                       f"one {int(counts.max())} times")
