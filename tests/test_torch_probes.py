"""The port's measured probes and telemetry against the JAX package, on the CPU.

The block probe (``kernels/autotune.py``): ``shape_key`` and
``candidate_blocks`` equal JAX's, the cache file's format equals JAX's, the
probe runs on the kernels' plain versions with its hit/miss counters
(mirroring tests/test_kernels.py's autotune cases), and a cache miss inside
a recorded (checkpointed) forward raises while the trainer's warm-up serves
it.  The layout probe (``launch/calibrate.py``) on ``uniform_narrow``: the
same steps and accounting as the JAX loader, and JAX's choice rule.
Telemetry: ``prometheus_text`` equals JAX's for the same instrument
operations, ``RunReporter`` writes its artifacts, the scrape server serves
them.  Both launchers run with every new flag under ``--device cpu --smoke``.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import OdbConfig as JaxOdbConfig
from repro.data import OnlineDynamicLoader as JaxLoader
from repro.data import get_dataset as jax_get_dataset
from repro.kernels import autotune as jax_autotune
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro_torch import obs
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core import OdbConfig
from repro_torch.data import get_dataset
from repro_torch.kernels import autotune
from repro_torch.launch import calibrate
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import LM
from repro_torch.models.attention import warm_flash_blocks
from repro_torch.models.model import shift_labels
from repro_torch.obs.metrics import MetricsRegistry
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


@pytest.fixture
def clean_obs(tmp_path, monkeypatch):
    """Fresh default registry and tracer, the probe's cache under tmp_path,
    and the tracer switched off again afterwards."""
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", tmp_path / "attn_blocks_cuda.json")
    obs.default_registry().reset()
    obs.default_tracer().reset()
    try:
        yield
    finally:
        obs.default_tracer().disable()
        obs.default_tracer().reset()
        obs.default_registry().reset()


# -- the block probe ---------------------------------------------------------------

KEY_CASES = [
    ((2, 512, 4, 2, 16), dict()),
    ((1, 128, 2, 1, 32), dict(has_segments=True)),
    ((1, 128, 2, 1, 32), dict(has_segments=True, grid="pruned")),
    ((3, 200, 16, 8, 128), dict(causal=False)),
    ((2, 6144, 16, 8, 128), dict(has_segments=True, grid="pruned", dtype="bfloat16")),
]


@pytest.mark.parametrize("case", KEY_CASES, ids=range(len(KEY_CASES)))
def test_shape_key_equals_jax(case):
    import jax.numpy as jnp

    cell, kw = case
    dtype = kw.pop("dtype", "float32")
    port = autotune.shape_key(*cell, dtype=getattr(torch, dtype), device="cpu", **kw)
    assert port == jax_autotune.shape_key(*cell, dtype=getattr(jnp, dtype), **kw)
    assert autotune.shape_key(*cell, dtype=getattr(torch, dtype), device="cuda", **kw) \
        == "gpu/" + port.split("/", 1)[1]


@pytest.mark.parametrize("s", [32, 40, 64, 96, 128, 200, 256, 384, 512, 6144, 7])
def test_candidate_blocks_equal_jax(s):
    assert autotune.candidate_blocks(s) == jax_autotune.candidate_blocks(s)
    assert autotune.heuristic_blocks(s) == jax_autotune.heuristic_blocks(s)


def test_cache_file_format_equals_jax(tmp_path):
    cache = {"cpu/b1s128h2kv1d32/float32/causal1/seg1/grid.dense": (64, 128),
             "gpu/b2s6144h16kv8d128/bfloat16/causal1/seg1/grid.pruned": (128, 128)}
    autotune._persist_cache(tmp_path / "port.json", cache)
    jax_autotune._persist_cache(tmp_path / "jax.json", cache)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    autotune._CACHES.pop(str(tmp_path / "jax.json"), None)
    assert autotune.cached_schedule(tmp_path / "jax.json") == cache


@pytest.mark.parametrize("grid", ["dense", "pruned"])
def test_autotune_probe_cached_and_counted(grid, tmp_path, clean_obs):
    """The probe on the plain versions picks a candidate, persists it under
    the JAX key, and a second call is a pure cache hit."""
    cache = tmp_path / "blocks.json"
    reg = obs.default_registry()
    picked = autotune.autotune_blocks(1, 128, 2, 1, 32, has_segments=True,
                                      cache_path=cache, grid=grid, device="cpu")
    assert picked in autotune.candidate_blocks(128)
    assert set(autotune.LAST_PROBE["seconds"]) == set(autotune.candidate_blocks(128))
    assert all(len(ts) == autotune.WINDOWS for ts in autotune.LAST_PROBE["windows"].values())
    assert reg.flat()["kernel_autotune_cache_misses_total"] == 1
    key = jax_autotune.shape_key(1, 128, 2, 1, 32, has_segments=True, grid=grid)
    assert json.loads(cache.read_text()) == {key: list(picked)}
    again = autotune.autotune_blocks(1, 128, 2, 1, 32, has_segments=True,
                                     cache_path=cache, grid=grid, device="cpu")
    assert again == picked
    assert reg.flat()["kernel_autotune_cache_hits_total"] == 1
    assert reg.flat()["kernel_autotune_cache_misses_total"] == 1


@pytest.mark.parametrize("windows, picked", [
    # (128, 128) is the heuristic at S = 128; (64, 64)'s lead of 0.1 sits
    # inside the heuristic's spread of 0.4: the heuristic stays.
    ({(128, 128): [1.0, 1.2, 1.4], (64, 64): [0.9, 1.1, 1.0]}, (128, 128)),
    # The same lead, beyond both spreads: the faster pair wins.
    ({(128, 128): [1.2, 1.2, 1.21], (64, 64): [1.0, 1.01, 1.0]}, (64, 64)),
    # The heuristic is the fastest: it stays whatever the spread.
    ({(128, 128): [0.5, 2.0, 0.6], (64, 64): [1.0, 1.0, 1.0]}, (128, 128)),
    # One window each (no spread): the lowest median wins.
    ({(128, 128): [1.0], (32, 64): [0.99]}, (32, 64)),
], ids=["within-spread", "beyond-spread", "heuristic-fastest", "one-window"])
def test_pick_blocks_keeps_heuristic_within_noise(windows, picked):
    assert autotune.pick_blocks(windows, 128) == picked


def test_pick_blocks_without_heuristic_candidate():
    """At S = 96 the heuristic's 96 is no candidate: the lowest median wins."""
    assert autotune.heuristic_blocks(96) not in autotune.candidate_blocks(96)
    assert autotune.pick_blocks({(32, 32): [2.0, 9.0, 2.0]}, 96) == (32, 32)


def test_autotune_rekeyed_by_grid(tmp_path, clean_obs):
    cache = tmp_path / "blocks.json"
    for grid in ("dense", "pruned"):
        autotune.autotune_blocks(1, 128, 2, 1, 32, has_segments=True,
                                 cache_path=cache, grid=grid, device="cpu")
    keys = set(json.loads(cache.read_text()))
    assert any("grid.dense" in k for k in keys) and any("grid.pruned" in k for k in keys)


def _autotune_model_and_batch():
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), attn_impl="flash",
                              attn_autotune=True, remat="full")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32))
    labels, mask = shift_labels(tokens, torch.ones(2, 128))
    return model, params, {"tokens": tokens, "labels": labels, "loss_mask": mask}


def test_cache_miss_inside_checkpointed_forward_raises(clean_obs):
    model, params, batch = _autotune_model_and_batch()
    with pytest.raises(RuntimeError, match="warm_flash_blocks"):
        model.loss_sums(params, batch)


def test_warmed_schedule_serves_the_checkpointed_forward(clean_obs):
    """After the warm-up the recorded forward reads the probe's pick, and its
    loss equals a run pinned to that pair."""
    model, params, batch = _autotune_model_and_batch()
    warm_flash_blocks(model.cfg, batch, model.dtype)
    reg = obs.default_registry()
    assert reg.flat()["kernel_autotune_cache_misses_total"] == 1
    picked = autotune.LAST_PROBE["best"]
    loss, _ = model.loss_sums(params, batch)
    loss.backward()
    pinned = LM(dataclasses.replace(model.cfg, attn_autotune=False, attn_block_q=picked[0],
                                    attn_block_kv=picked[1]), device="cpu")
    ref, _ = pinned.loss_sums(params, batch)
    assert float(loss) == float(ref)
    assert reg.flat().get("kernel_autotune_cache_hits_total", 0) == 0  # the forward counts nothing


# -- the layout probe ----------------------------------------------------------------

ODB = dict(l_max=512, buffer_size=64, prefetch_factor=16, num_workers=2)


def test_calibrate_layout_uniform_narrow(clean_obs):
    """Both layouts' steps and accounting equal the JAX loader's over the
    same steps; the choice follows JAX's rule."""
    cal = calibrate.calibrate_layout(get_dataset("uniform_narrow", scale=0.05), 2,
                                     OdbConfig(**ODB), steps=3, device="cpu")
    rows = cal["results"]
    for layout, row in rows.items():
        loader = JaxLoader(jax_get_dataset("uniform_narrow", scale=0.05), 2, JaxOdbConfig(**ODB),
                           layout=layout, vocab_size=512)
        steps = 0
        for _ in loader.epoch(0):
            steps += 1
            if steps >= 3:
                break
        acc = loader.accounting
        assert (row["steps"], row["real_tokens"], row["device_tokens"]) == (
            steps, acc.emitted_tokens, acc.device_tokens)
        assert row["device_padding_fraction"] == acc.device_padding_fraction
        assert row["steps_per_s"] > 0 and np.isfinite(row["final_loss"])
    dense, packed = rows["dense"], rows["packed"]
    if dense["steps_per_s"] != packed["steps_per_s"]:
        assert cal["layout"] == max(rows, key=lambda k: rows[k]["steps_per_s"])
    else:
        assert cal["layout"] == min(rows, key=lambda k: rows[k]["device_padding_fraction"])


# -- telemetry ------------------------------------------------------------------------


def _instrument(reg):
    reg.counter("req_total", help="requests", route="a").inc(3)
    reg.counter("req_total", help="requests", route="b").inc(0.5)
    reg.gauge("temp").set(1.5)
    reg.gauge("neg", unit="ratio").set(-2.25e-7)
    h = reg.histogram("lat_seconds", buckets=(1.0, 2.0), help="latency", unit="seconds")
    for v in (0.5, 2.0, 4.0):
        h.observe(v)
    reg.histogram("empty_seconds", buckets=(0.1,), kind="x")


def test_prometheus_text_equals_jax():
    port, ref = MetricsRegistry(), JaxRegistry()
    _instrument(port)
    _instrument(ref)
    assert port.prometheus_text() == ref.prometheus_text()
    assert port.snapshot() == ref.snapshot()
    assert 'lat_seconds_bucket{le="+Inf"} 3' in port.prometheus_text()


def test_reporter_writes_all_artifacts(tmp_path):
    reg = MetricsRegistry()
    tracer = obs.SpanTracer(enabled=True)
    reg.counter("odb_x_total").inc(4)
    with tracer.span("phase"):
        pass
    reporter = obs.RunReporter(tmp_path, registry=reg, tracer=tracer)
    paths = reporter.write(round_audit=obs.RoundTimeline(world_size=1), extra={"arch": "t"})
    assert set(paths) == {"metrics", "prometheus", "trace", "rounds"}
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert metrics["flat"]["odb_x_total"] == 4.0 and metrics["run"] == {"arch": "t"}
    assert "odb_x_total 4" in (tmp_path / "metrics.prom").read_text()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert [e["name"] for e in trace["traceEvents"]] == ["phase"]
    assert json.loads((tmp_path / "rounds.json").read_text())["rounds"] == 0


def test_enable_telemetry_switches_defaults_on(tmp_path, clean_obs):
    reg, tracer = obs.default_registry(), obs.default_tracer()
    reg.disable()
    assert not tracer.enabled
    reporter = obs.enable_telemetry(tmp_path)
    assert reg.enabled and tracer.enabled
    assert reporter.registry is reg and reporter.tracer is tracer


def test_scrape_server_serves_registry_and_stops(clean_obs):
    reg = MetricsRegistry()
    reg.counter("odb_scrape_test_total").inc(3)
    srv = obs.ScrapeServer(registry=reg, port=0).start()
    thread = srv._thread
    try:
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert resp.status == 200 and "text/plain" in resp.headers["Content-Type"]
            assert "odb_scrape_test_total 3" in resp.read().decode()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=5)
        assert err.value.code == 404
    finally:
        srv.stop()
    assert not thread.is_alive()
    srv.stop()
    late = obs.start_scrape_server(0)  # the default registry, read per request
    try:
        obs.counter("odb_scrape_late_total").inc()
        with urllib.request.urlopen(late.url, timeout=5) as resp:
            assert "odb_scrape_late_total 1" in resp.read().decode()
    finally:
        late.stop()


# -- the launchers with every new flag -------------------------------------------------


class _Scraper:
    """Captures the launcher's scrape server and GETs /metrics from a side
    thread until the body counts a finished train step."""

    def __init__(self, monkeypatch, module):
        self.bodies: list[tuple[int, str]] = []
        real = obs.start_scrape_server

        def start(port, *args, **kwargs):
            srv = real(port, *args, **kwargs)
            self.thread = threading.Thread(target=self._poll, args=(srv.url,), daemon=True)
            self.thread.start()
            return srv

        monkeypatch.setattr(module.obs, "start_scrape_server", start)
        self.done = threading.Event()

    def _poll(self, url):
        while not self.done.is_set():
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    self.bodies.append((resp.status, resp.read().decode()))
            except (urllib.error.URLError, ConnectionError):
                return
            if "\ntrain_steps_total 1" in self.bodies[-1][1]:
                return
            self.done.wait(0.05)


def test_train_launcher_every_new_flag(tmp_path, monkeypatch, clean_obs, capsys):
    scraper = _Scraper(monkeypatch, train_launcher)
    tel = tmp_path / "tel"
    train_launcher.main([
        "--smoke", "--device", "cpu", "--layout", "auto", "--calibration-steps", "2",
        "--steps", "3", "--world", "2", "--l-max", "512", "--dataset", "uniform_narrow",
        "--data-scale", "0.05", "--log-every", "1", "--attn-impl", "flash", "--attn-autotune",
        "--hosts", "2", "--round-deadline", "5", "--round-retries", "1",
        "--telemetry", str(tel), "--telemetry-port", "0",
    ])
    scraper.done.set()
    out = capsys.readouterr().out
    assert "[train] layout auto -> " in out and "calibrate dense" in out
    assert "eta_identity=0.0 eta_quota=0.0" in out
    assert {p.name for p in tel.iterdir()} == {"metrics.json", "metrics.prom", "trace.json",
                                               "rounds.json"}
    flat = json.loads((tel / "metrics.json").read_text())["flat"]
    assert flat["train_steps_total"] == 3 and flat["kernel_autotune_cache_misses_total"] >= 1
    assert json.loads((tel / "rounds.json").read_text())["rounds"] > 0
    assert autotune.DEFAULT_CACHE_PATH.exists()
    assert any(status == 200 and "\ntrain_steps_total " in body for status, body in scraper.bodies)


@pytest.mark.parametrize("flags", [
    ["--hosts", "3"],  # more hosts than ranks
    ["--round-deadline", "0"],  # a deadline must be positive
], ids=["hosts>world", "zero-deadline"])
def test_train_launcher_rejects_bad_flags(flags, clean_obs):
    args = train_launcher.parser().parse_args(
        ["--smoke", "--device", "cpu", "--world", "2", "--l-max", "512",
         "--dataset", "uniform_narrow", "--data-scale", "0.05", *flags])
    with pytest.raises(ValueError):
        trainer, _ = train_launcher.build(args)
        train_launcher.run(trainer, args)


def test_train_launcher_config_takes_deadline_and_hosts(clean_obs):
    args = train_launcher.parser().parse_args(
        ["--smoke", "--device", "cpu", "--world", "2", "--hosts", "2", "--round-deadline", "2.5",
         "--round-retries", "4", "--attn-autotune"])
    trainer, loader = train_launcher.build(args)
    assert loader.num_hosts == 2
    assert (loader.config.round_deadline_s, loader.config.round_retries) == (2.5, 4)
    assert trainer.model.cfg.attn_autotune


def test_serve_launcher_telemetry_flags(tmp_path, clean_obs, capsys):
    tel = tmp_path / "tel"
    serve_launcher.main(["--smoke", "--device", "cpu", "--requests", "6",
                         "--telemetry", str(tel), "--telemetry-port", "0"])
    out = capsys.readouterr().out
    assert "[serve] telemetry scrape: http://127.0.0.1:" in out
    assert {p.name for p in tel.iterdir()} == {"metrics.json", "metrics.prom", "trace.json"}
    assert "serve_" in (tel / "metrics.prom").read_text()
    assert json.loads((tel / "trace.json").read_text())["traceEvents"]


def test_params_from_jax_model_runs_with_autotune(clean_obs):
    """The probe's pick is used on a model carried from JAX weights too: a
    no-grad forward (the serving case) probes on a miss."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import LM as JaxLM

    jcfg = jax_smoke_config("qwen3_0_6b")
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), attn_impl="flash", attn_autotune=True)
    model = LM(cfg, device="cpu")
    params = model.load_params(params_from_jax(
        jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(0))), cfg, "cpu"))
    _, _, batch = _autotune_model_and_batch()
    with torch.no_grad():
        loss_sum, _ = model.loss_sums(params, batch)
    assert np.isfinite(float(loss_sum))
    assert obs.default_registry().flat()["kernel_autotune_cache_misses_total"] == 1
