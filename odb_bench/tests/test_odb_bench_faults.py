"""A whole run, past the look for a card, on the CPU at a small size: sound,
it comes out correct; with the timed path broken underneath, it does not.
Faults: a step that returns its state unchanged, half of the batch left out
(the mean over the rest), a token altered where the layout produces it.
(The cells run on one card, so there is no exchange between cards to
leave out.)"""

import numpy as np
import pytest
import torch

from odb_bench.tests import smallcell

CONFIGS = ("qwen3_0_6b", "mamba2_130m")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def state_unchanged(monkeypatch):
    from repro_torch.train import optimizer, trainer

    def no_update(params, grads, opt_state, cfg):
        return {"lr": torch.zeros(()), "grad_norm": optimizer.global_norm(grads)}

    monkeypatch.setattr(trainer, "adamw_update", no_update)


def half_batch(monkeypatch):
    from repro_torch.models.model import LM

    loss_sums = LM.loss_sums

    def half(self, params, batch):
        rows = batch["tokens"].shape[0]
        return loss_sums(self, params, {k: v[: rows // 2] for k, v in batch.items()})

    monkeypatch.setattr(LM, "loss_sums", half)


def token_altered(monkeypatch):
    from repro_torch.core import layout

    produce = layout.sample_token_ids

    def altered(sample, **kw):
        ids = np.array(produce(sample, **kw))
        k = len(ids) // 2
        ids[k] = 1 if ids[k] != 1 else 2
        return ids

    monkeypatch.setattr(layout, "sample_token_ids", altered)


@pytest.mark.parametrize("name", CONFIGS)
def test_sound_run_is_correct(name):
    out = smallcell.run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"tokens_per_s", "samples_per_s", "mfu", "setup_s"}


@pytest.mark.parametrize("name", CONFIGS)
def test_traced_run_reads_what_the_cpu_has(name):
    out = smallcell.run(name, trace=True)
    assert out["correct"]
    # No card: the device readers find nothing and are left out.
    assert {"data_wait_ms", "pad_share"} <= set(out["metrics"])
    assert not {"device_idle_share", "flash_roofline", "ssd_roofline"} & set(out["metrics"])


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, token_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CONFIGS)
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = smallcell.run(name)
    assert not out["correct"], out["checks"]
