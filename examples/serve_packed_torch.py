"""Serve a small LM with continuous batching over the packed-segment path,
on the PyTorch port.

Heterogeneous-length requests are admitted under the ODB ``l_max`` token
budget into a slot-based KV cache: each admission cohort prefills in ONE
packed segment-masked forward whose K/V scatters straight into
per-request cache slots, and every generated token costs one fixed-shape
``(num_slots, 1)`` decode step against the slot cache.  The flow and the
printout of ``examples/serve_packed.py``, on ``repro_torch``: on the CUDA
card (unless ``--device cpu``) the prefill and the closing check run the
pruned segment flash kernel; on the CPU they take its plain version.

    PYTHONPATH=src python examples/serve_packed_torch.py
    PYTHONPATH=src python examples/serve_packed_torch.py --device cpu
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import LM
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig


def main(argv=None) -> str:
    """Run the example; prints and returns its printout."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="the CUDA card unless 'cpu' is given")
    args = ap.parse_args(argv)
    lines: list[str] = []

    def say(line: str = "") -> None:
        print(line)
        lines.append(line)

    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), vocab_size=512)
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))

    # Incoming request queue: heterogeneous prompt AND decode lengths.
    rng = np.random.default_rng(0)
    engine = ContinuousBatchingEngine(
        model, params,
        ServeConfig(num_slots=4, max_len=160, l_max=512, lookahead=8),
        device=model.device,
    )
    rids = []
    for _ in range(12):
        prompt = rng.integers(1, cfg.vocab_size, size=int(rng.integers(8, 96)))
        rids.append(engine.submit(prompt, int(rng.integers(4, 24))))
    outputs = engine.run()

    st = engine.stats
    say(
        f"{len(rids)} requests -> {st.prefill_calls} packed prefill cohorts, "
        f"{st.decode_steps} decode steps "
        f"({100 * st.slot_decode_occupancy:.0f}% slot occupancy)"
    )
    say(
        f"slot reuse: {len(engine.slots.assignments)} allocations over "
        f"{engine.config.num_slots} slots; peak budget "
        f"{st.peak_projected_tokens}/{engine.config.l_max} tokens"
    )
    say(
        f"fixed shapes: decode ran at {engine.decode_traces} shape(s), prefill "
        f"buckets {dict(engine.prefill_traces)}"
    )
    for rid in rids[:3]:
        req = engine.requests[rid]
        say(
            f"  req {rid}: prompt {req.prompt_len} -> "
            f"{len(outputs[rid])} new tokens {[int(t) for t in outputs[rid][:6]]}..."
        )

    # The kernel on the packed layout (the card: K4; the CPU: its plain version).
    b, s, h, kv, d = 1, 128, 4, 2, 32
    g = torch.Generator(device=model.device).manual_seed(1)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=model.device) for n in (h, kv, kv))
    seg = torch.tensor([[1] * 50 + [2] * 60 + [0] * 18] * b, dtype=torch.int32, device=model.device)
    out = flash_attention(q, k, v, seg)
    route = "CUDA kernel" if out.is_cuda else "plain version"
    say(f"\nsegment flash attention ({route}) output: {tuple(out.shape)}, "
        f"finite={bool(torch.isfinite(out).all())}")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
