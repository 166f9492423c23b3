"""The port's weight cache, the estimator's cache load, and the
``import_weights`` and ``evaluate`` CLIs on the CPU; the evaluate CLI
against the JAX package's on one hub .pt imported into both packages'
caches (a tiny DPT registered in both registries)."""

import contextlib
import io
import json
import warnings

import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import DPT_PREPROCESS as JAX_DPT_PREPROCESS
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.tools import evaluate as jevaluate
from depth_estimation_tpu.tools import import_weights as jimport
from depth_estimation_tpu.utils import checkpoint as jckpt
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.tools import evaluate as tevaluate
from depth_estimation_tpu_torch.tools import import_weights as timport
from depth_estimation_tpu_torch.utils import checkpoint as tckpt
from tests.oracles import dpt_torch as oracle
from tests.test_torch_dpt import JAX_TINY, TINY

NAME = "DPT_Tiny_train_eval_test"


@pytest.fixture(scope="module", autouse=True)
def registered():
    jreg.register(jreg.ModelEntry(NAME, lambda: JaxDPT(JAX_TINY), JAX_DPT_PREPROCESS,
                                  lambda sd: convert_dpt(sd, JAX_TINY)))
    treg.register(treg.ModelEntry(NAME, lambda: DPT(TINY), DPT_PREPROCESS))


@pytest.fixture
def hub_pt(tmp_path, monkeypatch):
    """A tiny-DPT hub checkpoint (with the keys the forward never reads) and
    empty caches of both packages under ``tmp_path``."""
    monkeypatch.setenv(tckpt.CACHE_ENV, str(tmp_path / "torch_cache"))
    monkeypatch.setenv(jckpt.CACHE_ENV, str(tmp_path / "jax_cache"))
    sd = oracle.make_random_state_dict(JAX_TINY, seed=11)
    sd["pretrained.model.norm.weight"] = torch.ones(TINY.embed_dim)
    path = tmp_path / "tiny_dpt.pt"
    torch.save(sd, path)
    return path, sd


def _run(main, argv):
    buf = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(buf):
        warnings.simplefilter("ignore")
        rc = main(argv)
    return rc, buf.getvalue()


def test_import_caches_and_the_estimator_loads_it(hub_pt, monkeypatch):
    path, sd = hub_pt
    assert tckpt.load_params(NAME) is None
    rc, out = _run(timport.main, [str(path), NAME])
    assert rc == 0 and out.startswith(f"Imported {NAME}:")
    cached = tckpt.load_params(NAME)
    assert "pretrained.model.norm.weight" not in cached  # never read by the forward
    assert sorted(cached) == sorted(k for k in sd if k != "pretrained.model.norm.weight")
    meta = json.loads((tckpt.cache_dir() / NAME / "meta.json").read_text())
    assert meta == {"source_sha256": tckpt.content_hash(path), "model_type": NAME}
    # a re-import of the same content does no work
    with monkeypatch.context() as m:
        m.setattr(torch, "load", lambda *a, **k: pytest.fail("re-imported") if a[0] == path
                  else torch.serialization.load(*a, **k))
        assert sorted(tckpt.import_torch_checkpoint(path, NAME)) == sorted(cached)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no random-init warning: the cache is loaded
        est = DepthEstimator(NAME, verbose=False, device="cpu")
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_import_refuses_a_foreign_checkpoint(hub_pt, tmp_path):
    _, sd = hub_pt
    bad = dict(sd)
    bad.pop("scratch.output_conv.4.bias")
    bad["scratch.extra.weight"] = torch.zeros(1)
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(KeyError, match="missing .*scratch.output_conv.4.bias.*unexpected .*scratch.extra"):
        tckpt.import_torch_checkpoint(tmp_path / "bad.pt", NAME)
    assert tckpt.load_params(NAME) is None


def test_import_weights_cli_refuses_tflite_and_bad_arguments(capsys, tmp_path):
    """``--tflite`` with no file or a missing one, and a lone argument: usage errors (2)."""
    assert timport.main(["--tflite"]) == 2
    assert timport.main(["--tflite", str(tmp_path / "face_detection_short_range.tflite")]) == 2
    assert "no such file" in capsys.readouterr().err
    assert timport.main(["only_one_argument"]) == 2


def test_estimator_without_cache_warns_and_takes_random_weights(tmp_path, monkeypatch):
    monkeypatch.setenv(tckpt.CACHE_ENV, str(tmp_path / "empty"))
    with pytest.warns(UserWarning, match="No weights given or cached"):
        DepthEstimator(NAME, verbose=False, device="cpu")


def test_evaluate_cli_matches_jax(hub_pt):
    """One hub .pt imported into both caches; both evaluate CLIs on 3
    synthetic 48×64 pairs (a tail batch of 1 after a batch of 2), aligned and
    raw, print the same JSON within 1e-4."""
    path, _ = hub_pt
    assert _run(jimport.main, [str(path), NAME])[0] == 0
    assert _run(timport.main, [str(path), NAME])[0] == 0
    for extra in ([], ["--no-align"]):
        argv = ["--synthetic", "3", "--hw", "48", "64", "--model-type", NAME, "--batch", "2", *extra]
        want = json.loads(_run(jevaluate.main, argv)[1].strip().splitlines()[-1])
        rc, out = _run(tevaluate.main, [*argv, "--device", "cpu"])
        got = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and set(got) == set(want)
        assert got["images"] == want["images"] == 3 and got["aligned"] == want["aligned"] == (not extra)
        for k, v in want.items():
            if isinstance(v, float):
                assert abs(got[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got[k], v)


def test_evaluate_cli_needs_data():
    with pytest.raises(SystemExit):
        _run(tevaluate.main, ["--device", "cpu"])
