"""The MoE's expert parallelism (EP) over the mesh's ``model`` axis, on the CPU.

Spawned gloo ranks (``tests/_torch_rank_worker.ep_rank``) on a ``(1, W)``
host mesh, W = 2 and 4, each holding its shard of the MoE tree
(``launch.sharding.local_moe_params``): experts ``[e_start, e_start +
E/W)`` and the TP slices of the shared expert (DeepSeek-V3) and the dense
residual (Arctic).  Each rank's ``moe_ffn`` output and the gradients of
``sum(y * w)``, every leaf gathered back over ``model``, are held at fp32
2e-5 against the port's single-device branch and the JAX ``moe_ffn``: its
single-device branch in this process, and its ``shard_map`` branch on a
("data" 1, "model" W) mesh of forced host devices, run once in a subprocess
and cached for the module.  ``dispatch_chunks`` = 2 is held against JAX's
EP (the single-device branch ignores it in both packages).  The kept and
dropped (token, expert) pairs summed over the ranks equal the single
device's.  A whole smoke Arctic ``LM.loss_sums`` with its gradients, and an
engine run, at W = 2 equal W = 1.  Expert weights carry seeded per-expert
noise (the JAX init repeats one draw over the experts, which would hide a
wrong dispatch index), and the capacity factor is low enough that pairs
are dropped.
"""

import dataclasses
import multiprocessing as mp
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_worker
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.models import moe as jax_moe
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.launch.sharding import moe_shard
from repro_torch.models import LM, moe, shift_labels
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, synth_request_trace
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = dict(atol=2e-5, rtol=2e-5)
FACTOR = 0.5  # capacity factor: a single device drops pairs at 2 x 24 tokens
# (name, arch, config overrides, dispatch_chunks)
CASES = (
    ("arctic", "arctic_480b", {}, 1),  # the dense residual, TP inside the EP body
    ("arctic_chunks2", "arctic_480b", {}, 2),
    ("dsv3", "deepseek_v3_671b", {}, 1),  # the shared expert (n_shared_experts=1)
    ("dsv3_top4_chunks2", "deepseek_v3_671b", {"top_k": 4}, 2),
)
WORLDS = (2, 4)
LM_ARCH = "arctic_480b"
SERVE = dict(num_slots=4, max_len=64, l_max=256, lookahead=8)


def _cfgs(arch: str, overrides: dict):
    overrides = dict(overrides, capacity_factor=FACTOR)
    return (dataclasses.replace(jax_smoke_config(arch), **overrides),
            dataclasses.replace(get_smoke_config(arch), **overrides))


def _case_inputs(index: int, arch: str, overrides: dict, chunks: int) -> dict:
    """JAX MoE params (fp32 numpy) with per-expert noise, a gated dense
    residual for Arctic, tokens and the output weights, from seed ``index``."""
    jcfg, _ = _cfgs(arch, overrides)
    p = jax.tree.map(np.asarray, jax_moe.make_moe_params(jax.random.PRNGKey(index), jcfg, jnp.float32))
    rng = np.random.default_rng(100 + index)
    noisy = lambda w: (w + rng.standard_normal(w.shape) / np.sqrt(w.shape[-2])).astype(np.float32)  # noqa: E731
    for name in ("w_in", "w_gate", "w_out"):
        p[name] = noisy(p[name])
    if "shared" in p:
        p["shared"] = {k: noisy(v) for k, v in p["shared"].items()}
    dense = None
    if jcfg.dense_residual:
        d, ff = jcfg.d_model, jcfg.d_ff
        dense = {k: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
                 for k, shape in (("w_in", (d, ff)), ("w_gate", (d, ff)), ("w_out", (ff, d)))}
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    return dict(arch=arch, overrides=dict(overrides, capacity_factor=FACTOR), chunks=chunks,
                moe=p, dense=dense, x=x, w=w)


_JAX_EP = textwrap.dedent('''
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.models import moe

    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    out = {"devices": jax.device_count()}
    for world in inp["worlds"]:
        mesh = Mesh(np.array(jax.devices()[:world]).reshape(1, world), ("data", "model"))
        for case in inp["cases"]:
            cfg = dataclasses.replace(get_smoke_config(case["arch"]), **case["overrides"])
            fwd = lambda p, x: moe.moe_ffn(p["moe"], x, cfg, mesh=mesh, dense_params=p["dense"],
                                           dispatch_chunks=case["chunks"])
            p = jax.tree.map(jnp.asarray, {"moe": case["moe"], "dense": case["dense"]})
            loss = lambda p, x: jnp.sum(fwd(p, x) * case["w"])
            y = jax.jit(fwd)(p, case["x"])
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, case["x"])
            out[(world, case["name"])] = jax.tree.map(np.asarray, {"y": y, "dx": gx, "grads": gp})
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
''')


def _lm_inputs() -> dict:
    """The smoke Arctic LM from the JAX ``LM.init`` at seed 0, a batch of
    2 x 32 tokens and a serving trace."""
    cfg = get_smoke_config(LM_ARCH)
    params = jax.tree.map(np.asarray, JaxLM(jax_smoke_config(LM_ARCH)).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    labels, mask = shift_labels(torch.from_numpy(tokens), torch.ones(2, 32, dtype=torch.int32))
    batch = {"tokens": tokens, "labels": labels.numpy(), "loss_mask": mask.numpy()}
    trace = synth_request_trace(6, vocab=cfg.vocab_size, prompt_min=4, prompt_max=24, new_min=2,
                                new_max=8, seed=0)
    return dict(arch=LM_ARCH, overrides={}, params=params, batch=batch,
                trace=[(list(map(int, p)), int(n)) for p, n in trace], serve=SERVE)


def _spawn(world: int, tmp: pathlib.Path, inputs: dict) -> list:
    path = tmp / f"inputs{world}.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torch_rank_worker.ep_rank,
                         args=(r, world, str(tmp / f"pg{world}"), str(path), str(tmp / f"out{world}_{r}.pkl")))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs: list) -> None:
    for p in procs:
        p.join(180)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """Every rank's results at W = 2 and 4 and JAX's EP results, computed
    side by side: the JAX subprocess and the ranks start together."""
    tmp = tmp_path_factory.mktemp("ep")
    cases = [dict(_case_inputs(i, arch, over, chunks), name=name)
             for i, (name, arch, over, chunks) in enumerate(CASES)]
    with open(tmp / "jax_in.pkl", "wb") as f:
        pickle.dump({"cases": cases, "worlds": WORLDS}, f)
    src = str(pathlib.Path(jax_moe.__file__).resolve().parents[2])
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": src,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_EP, str(tmp / "jax_in.pkl"),
                                 str(tmp / "jax_out.pkl")], env=env, stderr=subprocess.PIPE, text=True)
    lm = _lm_inputs()
    ranks = {}
    try:
        for world in WORLDS:
            procs = _spawn(world, tmp, {"cases": cases, **({"lm": lm} if world == 2 else {})})
            _join(procs)
            ranks[world] = []
            for r in range(world):
                with open(tmp / f"out{world}_{r}.pkl", "rb") as f:
                    ranks[world].append(pickle.load(f))
        _, err = jax_proc.communicate(timeout=240)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    with open(tmp / "jax_out.pkl", "rb") as f:
        jax_ep = pickle.load(f)
    return dict(cases=cases, ranks=ranks, jax_ep=jax_ep, lm=lm)


def _port_single(case: dict) -> dict:
    """The port's single-device branch on the full tree: output, gradients
    and the kept / dropped pairs."""
    _, cfg = _cfgs(case["arch"], case["overrides"])
    tree = _torch_rank_worker._tree_like({"moe": case["moe"], "mlp": case["dense"]} if case["dense"]
                                         else {"moe": case["moe"]},
                                         lambda a: torch.from_numpy(a.copy()).requires_grad_())
    x = torch.from_numpy(case["x"]).requires_grad_()
    pairs: list = []
    with _torch_rank_worker.counted_pairs(pairs):
        y = moe.moe_ffn(tree["moe"], x, cfg, dense_params=tree.get("mlp"))
    leaves = _torch_rank_worker._leaves(tree)
    grads = torch.autograd.grad((y * torch.from_numpy(case["w"])).sum(), [x, *leaves])
    by_id = dict(zip(map(id, leaves), grads[1:]))
    return {"y": y.detach().numpy(), "dx": grads[0].numpy(), "pairs": pairs,
            "grads": _torch_rank_worker._tree_like(tree, lambda t: by_id[id(t)].numpy())}


def _jax_single(case: dict) -> dict:
    """The JAX single-device branch (``mesh=None``): output and gradients,
    in the rank results' layout (``moe`` / ``mlp``)."""
    jcfg, _ = _cfgs(case["arch"], case["overrides"])
    p = jax.tree.map(jnp.asarray, {"moe": case["moe"], "dense": case["dense"]})

    def fwd(p, x):
        return jax_moe.moe_ffn(p["moe"], x, jcfg, dense_params=p["dense"])

    y = jax.jit(fwd)(p, case["x"])
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(fwd(p, x) * case["w"]), argnums=(0, 1)))(p, case["x"])
    return _port_layout({"y": y, "dx": gx, "grads": gp})


def _port_layout(res: dict) -> dict:
    """A JAX result (``grads`` = {"moe", "dense"}) as numpy in the port's
    layer layout ({"moe", "mlp"})."""
    res = jax.tree.map(np.asarray, res)
    grads = {"moe": res["grads"]["moe"]}
    if res["grads"].get("dense") is not None:
        grads["mlp"] = res["grads"]["dense"]
    return {"y": res["y"], "dx": res["dx"], "grads": grads}


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _assert_same(ours: dict, ref: dict, tol=TOL) -> None:
    np.testing.assert_allclose(ours["y"], ref["y"], **tol)
    np.testing.assert_allclose(ours["dx"], ref["dx"], **tol)
    a, b = _flat(ours["grads"]), _flat(ref["grads"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in CASES if c[3] == 1])
def test_ep_equals_single_device_port_and_jax(ep, world, name):
    """dispatch_chunks = 1: every rank's output and gathered gradients equal
    the port's and JAX's single-device branch, and the kept and dropped
    pairs summed over the ranks equal the single device's."""
    i = [c["name"] for c in ep["cases"]].index(name)
    case = ep["cases"][i]
    port, jax_ref = _port_single(case), _jax_single(case)
    _assert_same(port, jax_ref)
    assert sum(d for _, d in port["pairs"]) > 0  # the capacity drops pairs
    for rank in ep["ranks"][world]:
        _assert_same(rank["cases"][i], port)
        _assert_same(rank["cases"][i], jax_ref)
    kept = sum(r["cases"][i]["pairs"][0][0] for r in ep["ranks"][world])
    dropped = sum(r["cases"][i]["pairs"][0][1] for r in ep["ranks"][world])
    assert (kept, dropped) == port["pairs"][0]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ep_equals_jax_ep(ep, world, name):
    """Each case, dispatch_chunks 1 and 2, against the JAX ``shard_map``
    branch on a ("data" 1, "model" W) mesh: output and every gradient."""
    i = [c["name"] for c in ep["cases"]].index(name)
    ref = _port_layout(ep["jax_ep"][(world, name)])
    for rank in ep["ranks"][world]:
        _assert_same(rank["cases"][i], ref)
    pairs = [r["cases"][i]["pairs"] for r in ep["ranks"][world]]
    assert all(len(p) == ep["cases"][i]["chunks"] for p in pairs)  # one dispatch per chunk


def test_dispatch_chunks_changes_the_capacity(ep):
    """Two chunks take the capacity of a chunk's tokens: at factor 0.5 they
    keep more pairs than one dispatch over all tokens (else the chunked
    cases would not test the chunk path)."""
    one = _port_single(ep["cases"][0])
    chunked = ep["ranks"][2][0]["cases"][1]
    assert not np.allclose(chunked["y"], one["y"], **TOL)
    kept = sum(k for r in ep["ranks"][2] for k, _ in r["cases"][1]["pairs"])
    assert kept > one["pairs"][0][0]


def test_jax_ep_gradient_scale_is_one(ep):
    """JAX's EP gradient, taken outside its ``shard_map``, is the gradient of
    the single-device MoE: ratio 1 on every leaf at W = 2 and 4 (unlike
    ``dp_shardmap_step``, which differentiates inside the shard_map:
    tests/test_torch_dp.py).  So the port's EP follows JAX's EP and the
    single device alike."""
    assert ep["jax_ep"]["devices"] == 4
    for i, case in enumerate(ep["cases"]):
        if case["chunks"] != 1:
            continue
        single = _flat(_jax_single(case)["grads"])
        for world in WORLDS:
            sharded = _flat(_port_layout(ep["jax_ep"][(world, case["name"])])["grads"])
            for k, g in single.items():
                ratio = float((sharded[k] * g).sum() / (g * g).sum())
                assert ratio == pytest.approx(1.0, abs=2e-5), (case["name"], world, k, ratio)


def _lm_single(lm: dict):
    cfg = dataclasses.replace(get_smoke_config(lm["arch"]), **lm["overrides"])
    model = LM(cfg, device="cpu")
    params = model.load_params(params_from_jax(lm["params"], cfg, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in lm["batch"].items()}
    pairs: list = []
    with _torch_rank_worker.counted_pairs(pairs):
        loss_sum, tokens = model.loss_sums(params, batch)
    leaves = _torch_rank_worker._leaves(params)
    grads = torch.autograd.grad(loss_sum / tokens, leaves)
    by_id = dict(zip(map(id, leaves), grads))
    gtree = params_to_jax(_torch_rank_worker._tree_like(params, lambda t: by_id[id(t)]), cfg)
    engine = ContinuousBatchingEngine(model, params, ServeConfig(**lm["serve"]), device="cpu")
    rids = [engine.submit(p, n) for p, n in lm["trace"]]
    outputs = engine.run()
    return dict(loss=float(loss_sum.detach() / tokens), pairs=pairs, grads=gtree,
                ids=[list(map(int, outputs[r])) for r in rids])


def test_lm_and_engine_at_world_2_equal_world_1(ep):
    """Smoke Arctic (2 MoE layers with the dense residual): ``LM(cfg,
    mesh=...)`` from each rank's shard of the JAX weights gives W = 1's loss
    and gradients (gathered to the JAX layout) at 2e-5, the same kept and
    dropped pairs per layer, and the engine the same ids."""
    ref = _lm_single(ep["lm"])
    ranks = ep["ranks"][2]
    for rank in ranks:
        assert rank["loss"] == pytest.approx(ref["loss"], abs=2e-5, rel=2e-5)
        a, b = _flat(rank["lm_grads"]), _flat(ref["grads"])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
        assert rank["ids"] == ref["ids"]
    summed = [tuple(map(sum, zip(*pair))) for pair in zip(*(r["lm_pairs"] for r in ranks))]
    assert summed == ref["pairs"]


def test_bad_divisibility_raises():
    """A model axis that does not divide the experts or a TP width raises:
    no floor, no fallback."""
    _, cfg = _cfgs("arctic_480b", {})
    with pytest.raises(ValueError, match="does not divide"):
        moe.ep_widths(cfg, 3)  # 8 experts
    with pytest.raises(ValueError, match="does not divide"):
        moe.ep_widths(dataclasses.replace(cfg, d_ff=98), 4)  # the dense residual's 98
    with pytest.raises(ValueError, match="does not divide"):
        moe.ep_widths(dataclasses.replace(get_smoke_config("deepseek_v3_671b"), moe_d_ff=30), 4)
    with fake_world(3):
        with pytest.raises(ValueError, match="does not divide"):
            LM(cfg, device="cpu", mesh=make_host_mesh(3))


def test_full_tree_on_an_ep_mesh_raises():
    """The EP branch wants the rank's shard; a full slab raises, and an
    engine whose mesh is not the model's raises."""
    _, cfg = _cfgs("arctic_480b", {})
    case = _case_inputs(0, "arctic_480b", {}, 1)
    with fake_world(2):
        mesh = make_host_mesh(2)
        p = _torch_rank_worker._tree_like(case["moe"], lambda a: torch.from_numpy(np.array(a)))
        with pytest.raises(ValueError, match="rank's shard"):
            moe.moe_ffn(p, torch.from_numpy(case["x"]), cfg, mesh=mesh)
        model = LM(cfg, device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="not the model's mesh"):
            ContinuousBatchingEngine(model, None, ServeConfig(**SERVE), device="cpu")


def test_lm_init_on_an_ep_mesh_cuts_the_seeded_tree():
    """``LM(cfg, mesh).init`` is this rank's cut (rank 0 of a fake group of
    2) of the tree the same seed draws without a mesh: 4 of the 8 experts,
    half the dense residual's width, every other leaf whole, none a view."""
    cfg = get_smoke_config("arctic_480b")
    full = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    want = moe_shard(full, cfg, 2, 0)
    with fake_world(2):
        got = LM(cfg, device="cpu", mesh=make_host_mesh(2)).init(torch.Generator().manual_seed(3))
    a, b = _torch_rank_worker._leaves(got), _torch_rank_worker._leaves(want)
    assert len(a) == len(b)
    assert all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))
    assert got["layers"][0]["moe"]["w_in"].shape[0] == 4 and got["layers"][0]["mlp"]["w_out"].shape[0] == 48
    assert not any(t._is_view() for t in a)
