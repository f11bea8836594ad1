"""The port's checkpoints, resume, remat, profiler hook and training CLI
(tip_tpu_torch/train/loop.py, train/model.py, train/__main__.py) on the
CPU, against the JAX package where it has the same: an npz checkpoint of
either package restores in the other (the JAX package's npz layout, orbax
blocked as tests/test_model.py blocks it), one Adam step from a restored
state gives optax's moments (rtol 1e-6 plus 1e-6 of the largest) and
parameters (rtol 1e-6 plus 2e-5 of the learning rate: optax's float32
bias corrections), a resumed run reproduces an
uninterrupted one (rtol 1e-6, test_model.py::test_train_resume_identical),
and remat gives the same loss (rtol 1e-6) and gradients (atol 1e-5) as
without it (test_model.py::test_remat_matches_no_remat).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tip_tpu.config import ModelConfig as JModelConfig
from tip_tpu.data import build_trigraph as j_build, synthetic_trigraph as j_raw
from tip_tpu.train import loop as jloop
from tip_tpu.train.model import TIP as JTIP
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
from tip_tpu_torch import convert
from tip_tpu_torch.convert import adam_to_optax_leaves as adam_leaves
from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.ops import typed_segment
from tip_tpu_torch.train import loop
from tip_tpu_torch.train.model import TIP, make_graph_arrays

RAW_KW = dict(n_drug=40, n_prot=70, n_et=5, pairs_per_et=50, seed=4)
SMALL = dict(dd_chunk=32, pp_window=64, pp_chunk=32)
WIDTHS = dict(mode="cat", prot_drug_dim=6, n_embed=10, n_hid1=8, n_hid2=6,
              num_base=4, pp_hid1=8, pp_hid2=6)
BASE = dict(lr=0.05, seed=4, log_every=0)


@pytest.fixture(scope="module")
def setup():
    """The same small graph in both packages, JAX's params and optax state
    after one update, and the port's chunked model."""
    jdata = j_build(j_raw(**RAW_KW), split_rate=0.9, seed=4)
    tdata = build_trigraph(synthetic_trigraph(**RAW_KW), split_rate=0.9,
                           seed=4)
    _, jgs = j_graph_arrays(jdata, **SMALL)
    jmodel = JTIP.for_data(JModelConfig(**WIDTHS), jdata, jgs)
    jparams = jmodel.init(jax.random.key(6))
    opt = optax.adam(0.01)
    grads = _random_like(jparams, seed=1)
    upd, jstate = opt.update(grads, opt.init(jparams), jparams)
    jparams = optax.apply_updates(jparams, upd)
    graph, gs = make_graph_arrays(tdata, "cpu", **SMALL)
    model = TIP.for_data(ModelConfig(**WIDTHS), tdata, gs, device="cpu")
    return tdata, jparams, jstate, graph, model


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
        tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jparams, lr=0.01):
    """Port params (from the JAX ones) and a fresh Adam over them."""
    params = convert.params_from_jax(_np(jparams), requires_grad=True)
    return params, torch.optim.Adam(convert.leaves(params), lr=lr, eps=1e-8)


def _block_orbax(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def test_optax_state_flattens_count_mu_nu(setup):
    """optax.adam's state flattens as count, the mu leaves, the nu leaves
    (each in the params' sorted-key order, convert.leaves'), which is the
    layout the port writes and reads."""
    _, jparams, jstate, _, _ = setup
    flat, _ = jax.tree.flatten(jstate)
    adam = jstate[0]
    want = [adam.count, *jax.tree.leaves(adam.mu), *jax.tree.leaves(adam.nu)]
    assert len(flat) == len(want)
    for a, b in zip(flat, want):
        assert a is b
    tp = convert.params_from_jax(_np(jparams))
    for a, b in zip(convert.leaves(tp), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.asarray(adam.count).dtype == np.int32 and adam.count.shape == ()


def test_port_round_trip_is_bit_exact(setup, tmp_path):
    _, jparams, _, _, _ = setup
    params, opt = _port_state(jparams)
    for k in range(2):  # two Adam steps on random grads
        for p, g in zip(convert.leaves(params), jax.tree.leaves(
                _random_like(jparams, seed=10 + k))):
            p.grad = torch.from_numpy(np.array(g))
        opt.step()
    path = str(tmp_path / "ep1")
    loop.save_checkpoint(path, loop.TrainState(params, opt, step=2))
    assert (tmp_path / "ep1.npz").exists()
    template, fresh = _port_state(_random_like(jparams, seed=3))
    got, got_opt, step = loop.restore_checkpoint(path, template, fresh)
    assert step == 2 and got is template and got_opt is fresh
    for a, b in zip(convert.leaves(got), convert.leaves(params)):
        assert torch.equal(a, b)
    for a, b in zip(adam_leaves(fresh, got), adam_leaves(opt, params)):
        np.testing.assert_array_equal(a, b)
    assert all(float(fresh.state[p]["step"]) == 2.0
               for p in convert.leaves(got))
    _, step = loop.restore_checkpoint(path, _port_state(jparams)[0])
    assert step == 2


def test_jax_npz_restores_in_port_and_adam_steps_as_optax(setup, tmp_path,
                                                         monkeypatch):
    """An npz written by tip_tpu's save_checkpoint (orbax blocked) restores
    in the port bit for bit; from it one torch.optim.Adam step equals one
    optax step on the same gradients (rtol 1e-6)."""
    _, jparams, jstate, _, _ = setup
    _block_orbax(monkeypatch)
    path = str(tmp_path / "ep0")
    jloop.save_checkpoint(path, jloop.TrainState(jparams, jstate, step=1))
    assert (tmp_path / "ep0.npz").exists()
    template, opt = _port_state(_random_like(jparams, seed=4))
    params, _, step = loop.restore_checkpoint(path, template, opt)
    assert step == 1
    for a, b in zip(convert.leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for a, b in zip(adam_leaves(opt, params), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, np.asarray(b))

    grads = _random_like(jparams, seed=5)
    upd, jnext = optax.adam(0.01).update(grads, jstate, jparams)
    jp = optax.apply_updates(jparams, upd)
    for p, g in zip(convert.leaves(params), jax.tree.leaves(grads)):
        p.grad = torch.from_numpy(np.array(g))
    opt.step()
    # the moments: torch's exp_avg.lerp_ and optax's (1 - b1) g + b1 mu
    # round differently where the two terms cancel, hence 1e-6 of the
    # largest as well
    for a, b in zip(adam_leaves(opt, params), jax.tree.leaves(jnext)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(b)).max())
    # the step itself: optax takes the bias corrections 1 - b ** count in
    # float32 (1 - 0.999 ** 2 is 1.3e-5 off there), torch in double, so
    # the step's size differs by up to ~1e-5 of itself (at most lr)
    for a, b in zip(convert.leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=2e-5 * 0.01)


def test_port_checkpoint_restores_in_jax(setup, tmp_path, monkeypatch):
    _, jparams, jstate, _, _ = setup
    params, opt = _port_state(jparams)
    path = str(tmp_path / "final")
    template, fresh = _port_state(jparams)
    convert.adam_from_optax_leaves(fresh, template, [
        np.asarray(x) for x in jax.tree.leaves(jstate)])
    loop.save_checkpoint(path, loop.TrainState(template, fresh, step=1))
    _block_orbax(monkeypatch)
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jp, jo, step = jloop.restore_checkpoint(path, zeros,
                                            optax.adam(0.01).init(zeros))
    assert step == 1
    for a, b in zip(jax.tree.leaves((jp, jo)),
                    jax.tree.leaves((jparams, jstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(jo[0].count).dtype == np.int32


@pytest.mark.parametrize("names,want", [
    (["ep3.npz", "ep10.npz", "ep9.npz", "final.npz"], "ep10"),
    (["final.npz"], "final"),
    (["ep2.orbax", "ep1.npz"], "ep2"),
    ([], None),
])
def test_latest_checkpoint(tmp_path, names, want):
    for name in names:
        if name.endswith(".orbax"):
            (tmp_path / name).mkdir()
        else:
            (tmp_path / name).write_bytes(b"")
    if want is None:
        with pytest.raises(FileNotFoundError):
            loop.latest_checkpoint(str(tmp_path))
        return
    assert loop.latest_checkpoint(str(tmp_path)) == str(tmp_path / want)
    # a direct prefix is taken as it is, in both packages
    prefix = str(tmp_path / want)
    assert loop.latest_checkpoint(prefix) == prefix
    assert jloop.latest_checkpoint(str(tmp_path)) == str(tmp_path / want)


def test_missing_optimizer_state_restores_params_and_fresh_adam(setup,
                                                                tmp_path):
    """Where the JAX package raises KeyError, the port restores the params,
    warns and starts Adam fresh."""
    _, jparams, _, _, _ = setup
    flat = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    path = str(tmp_path / "ep4")
    np.savez(f"{path}.npz", step=5, **{f"p{i}": x for i, x in enumerate(flat)})
    template, opt = _port_state(_random_like(jparams, seed=7))
    opt.state[convert.leaves(template)[0]]["step"] = torch.tensor(3.0)
    with pytest.warns(UserWarning, match="no optimizer state"):
        params, _, step = loop.restore_checkpoint(path, template, opt)
    assert step == 5 and len(opt.state) == 0
    for a, b in zip(convert.leaves(params), flat):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    assert int(adam_leaves(opt, params)[0]) == 0


@pytest.mark.parametrize("bad", ["shape", "leaves", "orbax", "missing"])
def test_restore_refuses(setup, tmp_path, bad):
    _, jparams, jstate, _, _ = setup
    params, opt = _port_state(jparams)
    path = str(tmp_path / "ck")
    if bad == "orbax":
        (tmp_path / "ck.orbax").mkdir()
        with pytest.raises(ValueError, match="ck.orbax"):
            loop.restore_checkpoint(path, params, opt)
        return
    if bad == "missing":
        with pytest.raises(FileNotFoundError):
            loop.restore_checkpoint(path, params, opt)
        return
    loop.save_checkpoint(path, loop.TrainState(params, opt, step=1))
    template = convert.params_from_jax(_np(jparams))
    if bad == "shape":
        template["decoder"]["weight"] = template["decoder"]["weight"][:, :3]
    else:
        template["decoder"]["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="template"):
        loop.restore_checkpoint(path, template)


def _train(tdata, monkeypatch, layout, **kw):
    if layout == "chunked":
        monkeypatch.setattr(loop, "preferred_dense_dtype",
                            lambda *a, **k: None)
    return loop.train(ModelConfig(**WIDTHS), TrainConfig(**BASE, **kw), tdata,
                      log=lambda s: None, device="cpu")


@pytest.mark.parametrize("layout", ["strips", "chunked"])
def test_train_resume_identical(setup, tmp_path, monkeypatch, layout):
    """Kill and resume reproduces an uninterrupted run: per-epoch seeds are
    step_seed(seed, epoch) and checkpoints carry Adam's state (rtol
    1e-6)."""
    tdata = setup[0]
    logs = []
    _, full = _train(tdata, monkeypatch, layout, epochs=8)
    ck = str(tmp_path / "ck")
    _train(tdata, monkeypatch, layout, epochs=4, checkpoint_dir=ck,
           checkpoint_every=4)
    assert sorted(os.listdir(ck)) == ["ep3.npz", "final.npz"]
    if layout == "chunked":
        monkeypatch.setattr(loop, "preferred_dense_dtype",
                            lambda *a, **k: None)
    _, resumed = loop.train(ModelConfig(**WIDTHS),
                            TrainConfig(epochs=8, **BASE), tdata,
                            log=logs.append, device="cpu", resume=ck)
    assert json.loads(logs[0]) == {"resumed_from": os.path.join(ck, "ep3"),
                                   "epoch": 4}
    assert [r["epoch"] for r in resumed["history"]] == [4, 5, 6, 7]
    tail = {r["epoch"]: r["loss"] for r in full["history"]}
    for r in resumed["history"]:
        np.testing.assert_allclose(r["loss"], tail[r["epoch"]], rtol=1e-6)
    for k in ("auprc", "auroc", "ap"):
        np.testing.assert_allclose(resumed["final"][k], full["final"][k],
                                   rtol=1e-6)


def _count_calls(monkeypatch, name):
    calls = [0]
    fn = getattr(typed_segment, name)

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    monkeypatch.setattr(typed_segment, name, counted)
    return calls


def test_remat_matches_no_remat_and_recomputes_the_encoder(setup,
                                                           monkeypatch):
    """The same loss and gradients with and without remat; with it the
    backward runs the encoder's forward ops again (the kernels' launches
    on the card: B4's forward and B5 once more a layer)."""
    tdata, jparams, _, graph, model = setup
    tns, spmm = (_count_calls(monkeypatch, n) for n in ("_tns_fwd", "_spmm"))
    out, counts = [], []
    for remat in (False, True):
        tns[0] = spmm[0] = 0
        params = convert.params_from_jax(_np(jparams), requires_grad=True)
        loss = model.loss(params, graph, seed=5, remat=remat)
        fwd = (tns[0], spmm[0])
        loss.backward()
        counts.append((fwd, (tns[0], spmm[0])))
        out.append((loss.item(), [p.grad.numpy() for p in
                                  convert.leaves(params)]))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    # two layers each: forward 2, backward 2 more of B5 (its own backward),
    # and with remat the forward's 2 of each again
    assert counts[0] == ((2, 2), (2, 4))
    assert counts[1] == ((2, 2), (4, 6))


def test_train_with_remat_matches_without(setup):
    tdata = setup[0]
    runs = [loop.train(ModelConfig(**WIDTHS),
                       TrainConfig(epochs=3, remat=remat, **BASE), tdata,
                       log=lambda s: None, device="cpu")[1]
            for remat in (False, True)]
    for a, b in zip(*(r["history"] for r in runs)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)


@pytest.mark.parametrize("epochs", [3, 6])
def test_profile_dir_writes_a_trace(setup, tmp_path, epochs):
    """epochs 2-4 traced (torch.profiler, CPU activities here), stopped at
    epoch 4 or, in a shorter run, at the loop's end."""
    tdata = setup[0]
    prof = tmp_path / "prof"
    loop.train(ModelConfig(**WIDTHS), TrainConfig(epochs=epochs, **BASE),
               tdata, log=lambda s: None, device="cpu",
               profile_dir=str(prof))
    trace = json.loads((prof / loop.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    steps = sum(n.startswith("Optimizer.step") for n in names)
    assert steps >= 1


def _cli(argv, capsys):
    from tip_tpu_torch.train.__main__ import main

    main(argv)
    return capsys.readouterr().out.splitlines()


def test_cli_resume_continues_at_the_saved_epoch(tmp_path, capsys):
    common = ["--synthetic", "--cpu", "--n-embed", "16", "--prot-drug-dim",
              "8", "--n-hid1", "16", "--n-hid2", "8", "--num-base", "8"]
    ck = str(tmp_path / "ck")
    _cli([*common, "--epochs", "6", "--out", str(tmp_path / "full.json")],
         capsys)
    _cli([*common, "--epochs", "4", "--checkpoint-dir", ck,
          "--checkpoint-every", "2"], capsys)
    assert sorted(os.listdir(ck)) == ["ep1.npz", "ep3.npz", "final.npz"]
    lines = _cli([*common, "--epochs", "6", "--resume", ck, "--out",
                  str(tmp_path / "resumed.json")], capsys)
    assert json.loads(lines[0]) == {"resumed_from": os.path.join(ck, "ep3"),
                                    "epoch": 4}
    full, resumed = (json.loads((tmp_path / f"{k}.json").read_text())
                     for k in ("full", "resumed"))
    assert [h["epoch"] for h in resumed["history"]] == [4, 5]
    for h in resumed["history"]:
        np.testing.assert_allclose(h["loss"],
                                   full["history"][h["epoch"]]["loss"],
                                   rtol=1e-6)


def _mono_raw(make):
    """``make``'s default synthetic graph with 0/1 mono features (the
    stubbed loader's answer)."""
    import scipy.sparse as sp

    raw = make()
    rng = np.random.default_rng(0)
    mono = sp.csr_matrix((rng.random((raw.n_drug, 12)) < 0.3).astype(
        np.float32))
    return dataclasses.replace(raw, drug_mono=mono)


def test_cli_mono_and_feat_norm_sqrt_match_the_jax_cli(monkeypatch, capsys):
    """--mono reaches the loader (stubbed: no Decagon files here), and
    --feat-norm sqrt gives the JAX CLI's d_norm on the same features."""
    import tip_tpu.data as jdata_mod
    import tip_tpu.utils
    import tip_tpu_torch.data as tdata_mod
    import tip_tpu_torch.data.decagon as tdecagon
    from tip_tpu.train.__main__ import main as jmain

    seen = {}

    def loader(tag, make):
        def load(**kw):
            seen[tag] = kw
            return _mono_raw(make)
        return load

    def capture(tag):
        def fake_train(cfg, tcfg, data, **kw):
            seen[f"{tag}_data"] = data
            return None, {"final": {}, "history": []}
        return fake_train

    monkeypatch.setattr(tdecagon, "load_decagon_raw",
                        loader("port", synthetic_trigraph))
    monkeypatch.setattr(tdata_mod, "cached_trigraph", tdata_mod.build_trigraph)
    monkeypatch.setattr(loop, "train", capture("port"))
    _cli(["--cpu", "--mono", "--feat-norm", "sqrt", "--epochs", "1"], capsys)
    assert seen["port"] == {"mono": True}

    monkeypatch.setattr(jdata_mod, "load_decagon_raw", loader("jax", j_raw))
    monkeypatch.setattr(jdata_mod, "cached_trigraph", jdata_mod.build_trigraph)
    monkeypatch.setattr(tip_tpu.utils, "enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(jloop, "train", capture("jax"))
    monkeypatch.setattr(sys, "argv", ["tip_tpu.train", "--cpu", "--mono",
                                      "--feat-norm", "sqrt", "--epochs", "1"])
    jmain()
    assert seen["jax"] == {"mono": True}
    port_norm = seen["port_data"].d_norm
    jax_norm = seen["jax_data"].d_norm
    assert port_norm is not None and port_norm.dtype == np.float32
    np.testing.assert_array_equal(port_norm, jax_norm)
    assert not np.allclose(port_norm, 1.0)
