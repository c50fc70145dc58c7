"""The port's serving engine against the JAX package's, plus the port's guards.

Both engines serve one request trace from one set of weights (the JAX
``LM.init``, brought over by ``bridge.params_from_jax``) on the CPU, in fp32
at smoke size.  They must give identical generated ids and stats, and the
picked prefill logits must agree within 1e-4.  Once on the plain route
(``attn_impl="xla"`` on both sides) and once on the flash route (the JAX
kernel in interpret mode, the port's kernel wrappers on their plain version).
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import LM
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, synth_request_trace
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = dict(num_slots=4, max_len=128, l_max=384, lookahead=8)
STATS = ("decode_steps", "prefill_calls", "admitted", "finished", "generated_tokens",
         "peak_projected_tokens", "peak_active_slots")


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_smoke_config("qwen3_0_6b")
    return jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.PRNGKey(0)))


def _record_prefill(engine, picked: list) -> None:
    """Wrap the engine's prefill step lookup so every call's picked logits
    are kept (the engines themselves discard them after the argmax)."""
    lookup = engine._prefill_fn

    def wrapped(shape):
        fn = lookup(shape)

        def call(*args):
            out, caches = fn(*args)
            picked.append(np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out))
            return out, caches

        return call

    engine._prefill_fn = wrapped


def _serve(engine, trace):
    picked: list = []
    _record_prefill(engine, picked)
    rids = [engine.submit(p, n) for p, n in trace]
    outputs = engine.run()
    return [outputs[r].tolist() for r in rids], engine.stats, picked


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_engine_matches_jax_engine(jax_params, impl):
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_0_6b"), attn_impl=impl)
    tcfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), attn_impl=impl)
    trace = synth_request_trace(10, vocab=tcfg.vocab_size, prompt_min=4, prompt_max=40,
                                new_min=2, new_max=16, seed=0)

    jids, jstats, jpicked = _serve(JaxEngine(JaxLM(jcfg), jax_params, JaxServeConfig(**CONFIG)), trace)
    model = LM(tcfg, device="cpu")
    params = model.load_params(params_from_jax(jax_params, tcfg, "cpu"))
    engine = ContinuousBatchingEngine(model, params, ServeConfig(**CONFIG), device="cpu")
    ids, stats, picked = _serve(engine, trace)

    assert ids == jids
    assert {k: getattr(stats, k) for k in STATS} == {k: getattr(jstats, k) for k in STATS}
    assert stats.finished == len(trace)
    assert engine.decode_traces == 1
    assert len(picked) == len(jpicked) == stats.prefill_calls
    for ours, theirs in zip(picked, jpicked):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_launcher_serves_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--device", "cpu", "--requests", "6"])
    serve.main()
    out = capsys.readouterr().out
    assert "tokens/s:" in out and "decode ran at 1 shape(s)" in out
    assert "generated ids[0]:" in out


def test_default_device_is_the_card():
    """With no device asked for, the port goes to CUDA or raises: never a
    silent CPU fallback."""
    cfg = get_smoke_config("qwen3_0_6b")
    if torch.cuda.is_available():
        assert LM(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(LM(cfg, device="cpu"), None, ServeConfig(**CONFIG))


# (n_layers, d_model, n_heads, n_kv_heads, d_head, d_ff, vocab_size): the published widths
FULL_WIDTHS = {
    "qwen3_0_6b": (28, 1024, 16, 8, 128, 3072, 151936),
    "olmo_1b": (16, 2048, 16, 16, 128, 8192, 50304),
    "deepseek_7b": (30, 4096, 32, 32, 128, 11008, 102400),
    "yi_34b": (60, 7168, 56, 8, 128, 20480, 64000),
    "chameleon_34b": (48, 8192, 64, 8, 128, 22016, 65536),
    "hubert_xlarge": (48, 1280, 16, 16, 80, 5120, 504),
    "arctic_480b": (35, 7168, 56, 8, 128, 4864, 32000),
    "deepseek_v3_671b": (61, 7168, 128, 128, 128, 18432, 129280),
    "jamba_1_5_large": (72, 8192, 64, 8, 128, 24576, 65536),
}


@pytest.mark.parametrize("arch", list(FULL_WIDTHS))
def test_full_width_config_matches_jax(arch):
    from repro.configs import get_config as jax_get_config
    from repro.configs import get_smoke_config as jax_get_smoke_config

    ours, theirs = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(jax_get_smoke_config(arch))
    assert (ours.n_layers, ours.d_model, ours.n_heads, ours.n_kv_heads, ours.d_head,
            ours.d_ff, ours.vocab_size) == FULL_WIDTHS[arch]


def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def test_port_imports_neither_jax_nor_repro():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "benchmarks"), f"{path}: imports {name}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch.serve, repro_torch.launch.serve, repro_torch.bridge, "
        "repro_torch.launch.train, repro_torch.kernels.ops, repro_torch.stream, "
        "repro_torch.stream.workers, repro_torch.chaos, repro_torch.data.oracles, "
        "repro_torch.kernels.liveness, repro_torch.launch.mesh, repro_torch.launch.sharding, "
        "repro_torch.launch.steps, repro_torch.launch.dryrun, repro_torch.launch.flash_dryrun, "
        "repro_torch.launch.perf, repro_torch.roofline, repro_torch.roofline.analysis, "
        "repro_torch.roofline.cost; "
        "import torch.distributed as dist; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
        "assert not bad, bad; "
        "assert not (dist.is_available() and dist.is_initialized()), 'a process group at import'"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


JAX_STEP_CACHE: dict = {}  # one set of compiled JAX steps for the tests below


def _drive_lifecycle(engine, trace):
    """Saturate 4 slots with 14 requests on a fake clock (one second per
    tick): every third request carries a 2 s queueing TTL and is shed if it
    waits longer, and the first resident request is evicted at the first
    tick that leaves three slots busy."""
    clock = {"now": 0.0}
    engine.time_fn = lambda: clock["now"]
    rids = [engine.submit(p, n, ttl_s=2.0 if i % 3 == 2 else None)
            for i, (p, n) in enumerate(trace)]
    engine.window.close()
    evicted = None
    while not engine.done:
        clock["now"] += 1.0
        engine.tick()
        if evicted is None and engine.slots.active_count >= 3:
            evicted = engine.slots.active()[0][1].rid
            engine.evict(evicted)
    return [(engine.requests[r].state, list(engine.requests[r].generated)) for r in rids]


@pytest.mark.parametrize("continuous", [True, False])
def test_eviction_shedding_and_static_mode_match_jax(jax_params, continuous):
    cfg = get_smoke_config("qwen3_0_6b")
    trace = synth_request_trace(14, vocab=cfg.vocab_size, prompt_min=4, prompt_max=40,
                                new_min=2, new_max=16, seed=3)
    jengine = JaxEngine(JaxLM(jax_smoke_config("qwen3_0_6b")), jax_params,
                        JaxServeConfig(**CONFIG, continuous=continuous), step_cache=JAX_STEP_CACHE)
    model = LM(cfg, device="cpu")
    params = model.load_params(params_from_jax(jax_params, cfg, "cpu"))
    engine = ContinuousBatchingEngine(model, params, ServeConfig(**CONFIG, continuous=continuous),
                                      device="cpu")
    theirs, ours = _drive_lifecycle(jengine, trace), _drive_lifecycle(engine, trace)
    assert ours == theirs
    keys = STATS + ("ticks", "evicted", "shed", "slot_decode_occupancy")
    assert {k: getattr(engine.stats, k) for k in keys} == {k: getattr(jengine.stats, k) for k in keys}
    assert engine.stats.evicted == 1 and engine.stats.shed > 0  # both paths were driven
    assert engine.slots.assignments == jengine.slots.assignments


def test_one_tick_emits_spans_and_metrics():
    from repro_torch import obs

    reg, tracer = obs.default_registry(), obs.default_tracer()
    reg.reset()
    tracer.reset()
    tracer.enable()
    try:
        cfg = get_smoke_config("qwen3_0_6b")
        model = LM(cfg, device="cpu")
        engine = ContinuousBatchingEngine(model, model.init(torch.Generator().manual_seed(0)),
                                          ServeConfig(**CONFIG), device="cpu")
        for p, n in synth_request_trace(2, vocab=cfg.vocab_size, prompt_min=4, prompt_max=20,
                                        new_min=3, new_max=6, seed=5):
            engine.submit(p, n)
        engine.tick()
        flat = reg.flat()
        assert flat["serve_ticks_total"] == 1 and flat["serve_admitted_total"] == 2
        assert flat["serve_ttft_seconds_count"] == 2
        assert flat["serve_slot_occupancy"] == 0.5
        assert flat["odb_window_realized_total"] == 2 and flat["odb_window_delivered_total"] == 2
        events = tracer.events()
        tick = [e for e in events if e["name"] == "serve/tick"][-1]
        for name in ("serve/admit", "serve/prefill", "serve/decode"):
            inner = [e for e in events if e["name"] == name][-1]
            assert tick["ts"] <= inner["ts"]
            assert inner["ts"] + inner["dur"] <= tick["ts"] + tick["dur"] + 1e-3
    finally:
        reg.reset()
        tracer.reset()
        tracer.disable()
