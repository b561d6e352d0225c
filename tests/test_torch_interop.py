"""Interop of the PyTorch port: reference ``.pth`` checkpoints imported by
``dvae_tpu_torch.utils.torch_import`` (and ``cli import-torch``) against the
JAX package's importer, and the parts of the JAX trainer's surface that
the port's trainer gained with them (``use_wandb``, ``append``,
``save_file``/``load_file``, ``cli train --wandb``).

The reference state dicts are built with torch from a numpy seed, with the
reference's names (mmidas/nn_model.py:184-255 ModuleLists, udagan.py:217-283
augmenter, cpl_mixvae.py:777-788 / augmentation/train.py:139-147 dict
formats); the constructors are those of ``tests/test_torch_import.py`` at this
file's widths (A=3, D=64, F=16, L=4, C=6, S=2).  Both importers convert in
numpy, so their outputs are held bit for bit: the parameter, statistic,
mask and moment bytes, the inferred sizes and the metadata.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from dvae_tpu.cli import main as jax_cli
from dvae_tpu.train.cpl_mixvae import CplMixVAE as JaxCplMixVAE
from dvae_tpu.utils import torch_import as jti

from dvae_tpu_torch import cli as tcli
from dvae_tpu_torch.augment.augmenter import load_augmenter
from dvae_tpu_torch.data.anndata_io import synthetic_dataset
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
from dvae_tpu_torch.utils import checkpoint as tckpt
from dvae_tpu_torch.utils import torch_import as tti

A, D, F, L, C, S = 3, 64, 16, 4, 6, 2
DIMS = dict(n_arm=A, input_dim=D, fc_dim=F, lowD_dim=L, n_categories=C,
            state_dim=S)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

rng = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Reference-layout checkpoints (the constructors of tests/test_torch_import.py)
# ---------------------------------------------------------------------------

def _t(*shape):
    return torch.tensor(rng.normal(size=shape).astype(np.float32))


def _mixvae_state_dict(zinb=False, pruned=False):
    """Reference ``model_state_dict`` with per-arm ModuleList names;
    torch Linear weights are (out, in)."""
    dims = {"fc1": (F, D), "fc2": (F, F), "fc3": (F, F), "fc4": (F, F),
            "fc5": (L, F), "fcc": (C, L),
            "fc_mu": (S, L + C), "fc_sigma": (S, L + C),
            "fc6": (L, C + S), "fc7": (F, L), "fc8": (F, F), "fc9": (F, F),
            "fc10": (F, F), "fc11": (D, F)}
    if zinb:
        dims["fc11_p"] = (D, F)
        dims["fc11_r"] = (D, F)
    sd = {}
    for name, (o, i) in dims.items():
        for a in range(A):
            if pruned and name == "fcc":
                mask = torch.ones(o, i)
                mask[-2:] = 0.0          # prune the last two categories
                sd[f"{name}.{a}.weight_orig"] = _t(o, i)
                sd[f"{name}.{a}.weight_mask"] = mask
            else:
                sd[f"{name}.{a}.weight"] = _t(o, i)
            sd[f"{name}.{a}.bias"] = _t(o)
    for i, d in zip(range(1, 6), (F, F, F, F, L)):
        for a in range(A):
            sd[f"batch_l{i}.{a}.running_mean"] = _t(d)
            sd[f"batch_l{i}.{a}.running_var"] = torch.abs(_t(d)) + 0.5
            sd[f"batch_l{i}.{a}.num_batches_tracked"] = torch.tensor(7)
    return sd


def _adam_sd(sd, lr=2e-3, step=11):
    """Torch Adam ``state_dict`` over the trainable params of ``sd`` in
    registration order (weight, bias per Linear; BN buffers excluded)."""
    keys = [k for k in sd
            if not k.startswith("batch_")
            and ("weight" in k or "bias" in k) and "mask" not in k]
    state = {i: {"step": torch.tensor(float(step)),
                 "exp_avg": 0.01 * torch.ones_like(sd[k]),
                 "exp_avg_sq": 0.02 * torch.ones_like(sd[k])}
             for i, k in enumerate(keys)}
    return {"state": state,
            "param_groups": [{"lr": lr, "params": list(range(len(keys)))}]}


def _augmenter_ckpt():
    NZ, Z, H = 4, 3, 10
    D5, H5 = D // 5, H // 5
    dims = {"fc1": (D5, D), "fc2": (D5, D5), "fc3": (H, D5),
            "fc4": (H, H), "fc5": (H5, H + NZ),
            "fc_mu": (Z, H5), "fc_sigma": (Z, H5),
            "fc6": (H5, Z), "fc7": (H, H5), "fc8": (H, H),
            "fc9": (D5, H), "fc10": (D5, D5), "fc11": (D, D5)}
    sd = {"noise.weight": _t(NZ, NZ),
          "bnz.weight": _t(NZ), "bnz.bias": _t(NZ),
          "bnz.running_mean": _t(NZ),
          "bnz.running_var": torch.abs(_t(NZ)) + 0.5,
          "bnz.num_batches_tracked": torch.tensor(3)}
    for name, (o, i) in dims.items():
        sd[f"{name}.weight"] = _t(o, i)
        sd[f"{name}.bias"] = _t(o)
    bn_dims = {"batch_fc1": D5, "batch_fc2": D5, "batch_fc3": H,
               "batch_fc4": H, "batch_fc5": H5, "batch_fc_mu": Z,
               "batch_fc6": H5, "batch_fc7": H, "batch_fc8": H,
               "batch_fc9": D5, "batch_fc10": D5}
    for name, d in bn_dims.items():
        sd[f"{name}.running_mean"] = _t(d)
        sd[f"{name}.running_var"] = torch.abs(_t(d)) + 0.5
    return {"netA": sd, "netD": {}, "optimA": {}, "optimD": {},
            "parameters": {"num_n": NZ, "num_z": Z, "n_features": D,
                           "n_dim": H}}


def _prefixed(sd):
    """The names a DDP-wrapped, compiled model saves under."""
    return {f"module._orig_mod.{k}": v for k, v in sd.items()}


_CASES = {
    "mse": lambda: {"model_state_dict": (sd := _mixvae_state_dict()),
                    "optimizer_state_dict": _adam_sd(sd)},
    "zinb": lambda: {"model_state_dict": (sd := _mixvae_state_dict(True)),
                     "optimizer_state_dict": _adam_sd(sd, lr=5e-4, step=3)},
    "pruned": lambda: {"model_state_dict": (sd := _mixvae_state_dict(
        pruned=True)), "optimizer_state_dict": _adam_sd(sd)},
    "prefixed": lambda: {"model_state_dict": _prefixed(
        sd := _mixvae_state_dict()), "optimizer_state_dict": _adam_sd(sd)},
    "bare": lambda: _mixvae_state_dict(),
}


def _assert_bits(got, want, where=""):
    """Two numpy trees (dicts, tuples, ForeignStates) equal bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_bits(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bits(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        assert g.tobytes() == w.tobytes(), where


def _write(tmp_path, case, name="cpl_mixVAE_model_epoch_40.pth"):
    path = str(tmp_path / name)
    torch.save(_CASES[case](), path)
    return path


# ---------------------------------------------------------------------------
# The importer against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mse", "zinb", "pruned", "prefixed"])
def test_state_dict_conversion_matches_jax(case):
    sd = _CASES[case]()["model_state_dict"]
    got = tti.mixvae_from_state_dict(sd)
    want = jti.mixvae_from_state_dict(sd)
    for g, w in zip(got[:3], want[:3]):
        _assert_bits(g, w)
    assert got[3] == want[3]
    bare = sd if case != "prefixed" else tti._strip_prefixes(sd)
    w = bare["fc1.1.weight"].numpy().T
    assert got[0]["fc1"]["w"][1].tobytes() == w.tobytes()
    if case == "pruned":
        assert got[2].tolist() == [1.0] * (C - 2) + [0.0, 0.0]
        assert np.all(got[0]["fcc"]["w"][:, :, -2:] == 0)


@pytest.mark.parametrize("case", ["mse", "zinb", "pruned", "prefixed", "bare"])
@pytest.mark.parametrize("optimizer", [True, False])
def test_import_writes_the_checkpoint_jax_writes(case, optimizer, tmp_path):
    pth = _write(tmp_path, case)
    got = tti.import_mixvae_checkpoint(pth, str(tmp_path / "port.ckpt"),
                                       import_optimizer=optimizer)
    want = jti.import_mixvae_checkpoint(pth, str(tmp_path / "jax.ckpt"),
                                        import_optimizer=optimizer)
    gtree, gmeta = tckpt.load_checkpoint(got)
    wtree, wmeta = tckpt.load_checkpoint(want)
    _assert_bits(gtree, wtree)
    assert gmeta == wmeta
    moved = optimizer and case in ("mse", "zinb", "prefixed")
    assert gmeta["moments_imported"] is moved
    assert gmeta["epoch"] == 40
    count, mu, nu = tckpt.adam_state_from_jax(gtree["opt_state"])
    if moved:
        assert count == (3 if case == "zinb" else 11)
        assert np.all(mu["fc11"]["w"] == np.float32(0.01))
        assert np.all(nu["fc_sigma"]["b"] == np.float32(0.02))
    else:
        assert count == 0 and not np.any(mu["fc1"]["w"])


def test_adam_slots_follow_checkpoint_key_order():
    """Torch numbers the moments by position: the slots follow the state
    dict's key order (fc_sigma registered before fc_mu here), as in JAX."""
    sd = _mixvae_state_dict()
    reordered = dict(sorted(sd.items(), key=lambda kv: kv[0].replace(
        "fc_sigma", "fc_m0")))
    params = tti.mixvae_from_state_dict(reordered)[0]
    opt_sd = _adam_sd(reordered)
    for i in opt_sd["state"]:
        opt_sd["state"][i]["exp_avg"] *= (i + 1)
    count, mu, nu = tti._adam_state_from_torch(opt_sd, params,
                                               list(reordered))
    jst = jti._adam_state_from_torch(opt_sd, params, 1e-3, list(reordered))
    _assert_bits(mu, jax.tree_util.tree_map(np.asarray, jst[0].mu))
    _assert_bits(nu, jax.tree_util.tree_map(np.asarray, jst[0].nu))
    assert count == int(jst[0].count) == 11
    keys = [k for k in reordered
            if not k.startswith("batch_") and "mask" not in k]
    i_sig = keys.index("fc_sigma.0.weight")
    np.testing.assert_allclose(mu["fc_sigma"]["w"][0], 0.01 * (i_sig + 1),
                               rtol=1e-6)


def test_augmenter_import_matches_jax(tmp_path):
    pth = str(tmp_path / "augmenter.pth")
    ck = _augmenter_ckpt()
    sd = ck["netA"]
    w = sd.pop("fc1.weight")                 # one layer left pruned
    sd["fc1.weight_orig"], sd["fc1.weight_mask"] = w, torch.ones_like(w)
    torch.save(ck, pth)
    got = tti.import_augmenter_checkpoint(pth, str(tmp_path / "p.ckpt"))
    want = jti.import_augmenter_checkpoint(pth, str(tmp_path / "j.ckpt"))
    gtree, gmeta = tckpt.load_checkpoint(got)
    wtree, wmeta = tckpt.load_checkpoint(want)
    _assert_bits(gtree, wtree)
    assert gmeta == wmeta
    params, bn, cfg = load_augmenter(got)
    assert cfg.input_dim == D and cfg.noise_dim == 4 and cfg.n_dim == 10
    assert params["noise"]["b"] is None and "scale" in bn["bnz"]
    np.testing.assert_array_equal(params["fc1"]["w"].numpy(), w.numpy().T)


@pytest.mark.parametrize("kind", ["model", "augmenter"])
def test_cli_import_torch_auto_detects(kind, tmp_path, capsys):
    """``import-torch`` (``--kind auto``) of either package writes the same
    file from the same ``.pth``."""
    pth = str(tmp_path / f"{kind}.pth")
    torch.save(_CASES["zinb"]() if kind == "model" else _augmenter_ckpt(),
               pth)
    out_t, out_j = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    assert tcli.main(["import-torch", pth, "--out", out_t]) == 0
    assert f"imported {kind} checkpoint -> {out_t}" in capsys.readouterr().out
    assert jax_cli(["import-torch", pth, "--out", out_j]) == 0
    _assert_bits(tckpt.load_checkpoint(out_t)[0],
                 tckpt.load_checkpoint(out_j)[0])


def test_cli_import_torch_kind_and_no_optimizer(tmp_path):
    pth = _write(tmp_path, "mse")
    out = str(tmp_path / "fresh.ckpt")
    assert tcli.main(["import-torch", pth, "--kind", "model",
                      "--no-optimizer", "--out", out]) == 0
    tree, meta = tckpt.load_checkpoint(out)
    assert meta["moments_imported"] is False
    assert tckpt.adam_state_from_jax(tree["opt_state"])[0] == 0
    # the default output lands beside the input
    assert tcli.main(["import-torch", pth]) == 0
    assert os.path.exists(pth[:-len(".pth")] + ".ckpt")


@pytest.mark.parametrize("case", ["mse", "zinb", "pruned"])
def test_imported_checkpoint_serves_in_both_packages(case, tmp_path):
    ckpt = tti.import_mixvae_checkpoint(_write(tmp_path, case))
    x = synthetic_dataset(30, D, C, seed=3).log1p
    if case == "zinb":
        x = np.round(x)
    port = CplMixVAE(device="cpu")
    port.load_model(ckpt)
    jax_side = JaxCplMixVAE()
    jax_side.load_model(ckpt)
    assert port.cfg.mode == jax_side.cfg.mode == case.upper().replace(
        "PRUNED", "MSE")
    got = port.eval_model(x, batch_size=16)
    want = jax_side.eval_model(x, batch_size=16)
    np.testing.assert_array_equal(got["pred_label"], want["pred_label"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    if case == "pruned":
        assert not np.isin(got["pred_label"], [C - 2, C - 1]).any()


def test_fortran_ordered_checkpoints_load_contiguous(tmp_path):
    """Fault C10: an array stored in Fortran order (pickle protocol 5 keeps
    the layout; a reference import can write one) loaded as a strided
    tensor, which the CUDA kernels refuse ("operand w is not contiguous").
    Every loaded tensor is now C-contiguous and equal to the stored array,
    through ``load_model``, ``load_vae`` and ``load_augmenter``."""
    from dvae_tpu_torch.models.api import load_vae
    path = tti.import_mixvae_checkpoint(_write(tmp_path, "zinb"))
    tree, meta = tckpt.load_checkpoint(path)
    fortran = jax.tree_util.tree_map(
        lambda v: np.asfortranarray(v) if np.ndim(v) >= 2 else v, tree)
    f_path = tckpt.save_checkpoint(str(tmp_path / "fortran.ckpt"), fortran,
                                   meta)
    f_tree, _ = tckpt.load_checkpoint(f_path)
    assert not f_tree["params"]["fc11"]["w"].flags["C_CONTIGUOUS"]
    cpl = CplMixVAE(device="cpu")
    cpl.load_model(f_path)
    _, params, bn, _ = load_vae(f_path, device="cpu")
    _, mu, nu = tckpt.adam_state_from_jax(f_tree["opt_state"])
    for got, want in ((cpl.state.params, tree["params"]),
                      (params, tree["params"]), (bn, tree["bn"]),
                      (cpl.state.opt_state.mu, tckpt.params_from_jax(mu))):
        for name, layer in want.items():
            for k, v in layer.items():
                assert got[name][k].is_contiguous(), (name, k)
                np.testing.assert_array_equal(got[name][k].numpy(),
                                              np.asarray(v))
    torch.save(_augmenter_ckpt(), str(tmp_path / "a.pth"))
    aug = tti.import_augmenter_checkpoint(str(tmp_path / "a.pth"))
    a_tree, a_meta = tckpt.load_checkpoint(aug)
    a_f = tckpt.save_checkpoint(
        str(tmp_path / "a_fortran.ckpt"),
        jax.tree_util.tree_map(np.asfortranarray, a_tree), a_meta)
    a_params, _, _ = load_augmenter(a_f)
    assert all(v.is_contiguous() for layer in a_params.values()
               for v in layer.values() if v is not None)


# ---------------------------------------------------------------------------
# The trainer surface
# ---------------------------------------------------------------------------

def test_trainer_without_wandb_falls_back_and_trains(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)   # not installed
    x = synthetic_dataset(64, D, C, seed=4).log1p
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=1,
                    use_wandb=True)
    cpl.init_model(**DIMS, batch_size=32, epochs_per_jit=1)
    path = cpl.train(x, n_epoch=1, early_stop_consensus=0, save_plots=False)
    assert "falling back to local logging" in capsys.readouterr().out
    assert os.path.exists(path) and cpl.state.opt_state.count == 2


def test_trainer_logs_the_jax_keys_to_wandb(tmp_path, monkeypatch):
    """With wandb present the port's run logs each epoch under the JAX
    trainer's keys (tests/test_logging_wandb.py's key set)."""
    mod = types.ModuleType("wandb")
    mod.init_calls, mod.logged = [], []
    mod.init = lambda **kw: mod.init_calls.append(kw)
    mod.log = lambda metrics, step=None: mod.logged.append((metrics, step))
    mod.finish = lambda: None
    monkeypatch.setitem(sys.modules, "wandb", mod)
    x = synthetic_dataset(64, D, C, seed=5).log1p
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu",
                    use_wandb=True)
    cpl.init_model(**DIMS, batch_size=32, epochs_per_jit=1)
    cpl.train(x, n_epoch=2, run_name="keys", early_stop_consensus=0,
              save_plots=False)
    assert mod.init_calls[0]["name"] == "keys"
    assert mod.init_calls[0]["config"]["n_arm"] == A
    rows = [(m, s) for m, s in mod.logged if any(k.startswith("train/")
                                                  for k in m)]
    want = {"train/loss", "train/loss_joint", "train/neg_joint_entropy",
            "train/simplex_distance", "train/l2_distance",
            "train/consensus", "train/epoch_time_s", "train/device_mb",
            *(f"train/rec_loss_arm{a}" for a in range(A))}
    assert [set(m) for m, _ in rows] == [want, want]
    assert [s for _, s in rows] == [0, 1]


def test_cli_train_with_wandb_flag_trains(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["train", "--device", "cpu", "--synthetic",
                      "--syn_cells", "80", "--syn_genes", "24",
                      "--syn_types", "4", "--n_categories", "4", "--n_arm",
                      "2", "--fc_dim", "8", "--latent_dim", "4",
                      "--batch_size", "32", "--n_epoch", "1",
                      "--epochs_per_jit", "1", "--wandb", "--saving_folder",
                      str(tmp_path) + "/"]) == 0
    out = capsys.readouterr().out
    assert "falling back to local logging" in out
    assert "final checkpoint" in out


def test_append_builds_the_jax_entry_and_leaves_the_trainer(tmp_path):
    port = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=2)
    port.init_model(**DIMS, batch_size=16)
    before = port.state.params["fc1"]["w"].clone()
    cfg0, state0 = port.cfg, port.state
    jax_side = JaxCplMixVAE(seed=2)
    jax_side.init_model(**DIMS, batch_size=16)
    kw = dict(DIMS, n_categories=C + 2, mode="ZINB", batch_size=8)
    got = port.append(**kw)
    want = jax_side.append(**kw)
    assert got["cfg"] == type(port.cfg)(**want["cfg"].__dict__)
    assert got["tcfg"].batch_size == want["tcfg"].batch_size == 8
    assert port.models == [got] and len(jax_side.models) == 1
    assert port.cfg is cfg0 and port.state is state0
    assert torch.equal(port.state.params["fc1"]["w"], before)
    assert got["state"].params["fc11_p"]["w"].shape == (A, F, D)
    # trained_model= loads weights into the new entry only
    path = port.save_checkpoint("e0")
    # the checkpoint lands in the run folder, never the working directory
    assert os.path.dirname(os.path.abspath(path)) == str(tmp_path)
    again = port.append(**DIMS, trained_model=path)
    assert torch.equal(again["state"].params["fc1"]["w"], before)
    assert len(port.models) == 2 and port.state is state0


def test_save_file_round_trip_reads_in_both_packages(tmp_path):
    arrays = {"c_prob": np.random.default_rng(6).random((2, 5, 3)),
              "labels": np.arange(10)}
    port = CplMixVAE(device="cpu")
    p = str(tmp_path / "port.p")
    port.save_file(p, **arrays)
    back = JaxCplMixVAE().load_file(p)
    q = str(tmp_path / "jax.p")
    JaxCplMixVAE().save_file(q, **arrays)
    for loaded in (back, port.load_file(q), port.load_file(p)):
        assert set(loaded) == set(arrays)
        for k in arrays:
            np.testing.assert_array_equal(loaded[k], arrays[k])


# ---------------------------------------------------------------------------
# The port stands alone on the new modules
# ---------------------------------------------------------------------------

_BLOCKED = """
import importlib.abc, json, sys
import numpy as np, torch
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "pandas",
                                  "sklearn", "dvae_tpu"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, Block())
torch.set_num_threads(1)
from dvae_tpu_torch import cli
from dvae_tpu_torch.models import api
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
cpl = CplMixVAE(device="cpu", seed=3)
cpl.init_model(n_arm=2, input_dim=20, fc_dim=8, lowD_dim=4, n_categories=4,
               use_pallas=True, batch_size=8)
path = cpl.save_checkpoint("x")
cfg, params, bn, mask = api.load_vae(path, device="cpu")
x = np.random.default_rng(0).random((19, 20)).astype("float32")
gen = api.generate(cfg, params, bn, x, mask=mask, batch_size=8)
from dvae_tpu_torch.examples.state_traversal import traversal_study
trav = traversal_study(cfg, params, bn, x[:5], n_samp=3)
from dvae_tpu_torch.eval.evaluate import evals2_files
e2 = evals2_files(path, path, x, batch_size=8, device="cpu")
cli.main(["import-torch", sys.argv[1], "--out", "imported.ckpt"])
imp = CplMixVAE(device="cpu")
imp.load_model("imported.ckpt")
from dvae_tpu_torch.analysis import tree_based, tree_helpers
print(json.dumps({"recon": list(gen["recon"].shape),
                  "trav": list(trav["recon"].shape),
                  "same_labels": bool(np.array_equal(e2["labels_a"],
                                                     e2["labels_b"])),
                  "imported_arms": imp.cfg.n_arm,
                  "bad": sorted(m for m in sys.modules if m.split(".")[0] in
                                ("jax", "jaxlib", "optax", "pandas",
                                 "sklearn", "dvae_tpu"))}))
"""


def test_new_modules_run_with_jax_pandas_sklearn_blocked(tmp_path):
    """``load_vae`` → ``generate``, the traversal study, ``evals2_files`` and
    ``cli import-torch`` run in a fresh interpreter in which, once numpy
    and torch are loaded, importing jax, optax, pandas, sklearn or
    dvae_tpu raises."""
    pth = _write(tmp_path, "mse")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, pth],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"recon": [2, 19, 20], "trav": [2, 3, 5, 20],
                   "same_labels": True, "imported_arms": A, "bad": []}
