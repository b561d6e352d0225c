"""What an installation of the port needs beside its Python modules, and
its command line against the JAX package's.

* The package data cover every header a kernel source includes, and the
  kernels build into the directory that ``DVAE_TORCH_BUILD_DIR`` names.
* The ``train`` and ``evaluate`` parsers of ``dvae_tpu_torch.cli`` know
  every option string of ``dvae_tpu.cli``'s; the options of features still
  to port raise the trainer's ``NotImplementedError``, the ported ones
  (``--stream`` and the dataset flags among them) reach the trainer.
"""

import argparse
import fnmatch
import os
import re
import sys
import tomllib

import pytest

from dvae_tpu_torch import cli as tcli
from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(p.name for p in _build.CSRC.glob("*.cu"))


# ---------------------------------------------------------------------------
# Package data and the build directory
# ---------------------------------------------------------------------------

def _package_data():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)
    return meta["tool"]["setuptools"]["package-data"]["dvae_tpu_torch"]


def _packaged(rel: str) -> bool:
    return any(fnmatch.fnmatch(rel, pat) for pat in _package_data())


@pytest.mark.parametrize("source", SOURCES)
def test_package_data_cover_each_kernel_and_its_includes(source):
    """Every ``csrc/*.cu`` and every file it includes with quotes, headers
    included by headers too, is matched by a package-data pattern."""
    seen, todo = set(), [source]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        text = (_build.CSRC / name).read_text()
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            assert (_build.CSRC / inc).is_file(), f"{name} includes {inc}"
            todo.append(inc)
    assert len(SOURCES) == len(_build.KERNELS)
    for name in sorted(seen):
        assert _packaged(f"csrc/{name}"), f"csrc/{name} is not packaged"


def test_every_shared_header_is_packaged():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert headers, "expected the shared headers under csrc/"
    assert all(_packaged(f"csrc/{h}") for h in headers)


def test_build_directory_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert _build.build_dir() == _build.BUILD_DIR
    assert _build.library_path("zinb_fwdbwd").parent == _build.BUILD_DIR
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert _build.build_dir() == tmp_path / "kernels"
    for name in _build.KERNELS:
        path = _build.library_path(name)
        assert path.parent == tmp_path / "kernels"
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    # an empty value means the default, as an unset one does
    monkeypatch.setenv(_build.BUILD_DIR_ENV, "")
    assert _build.build_dir() == _build.BUILD_DIR


def test_build_creates_the_directory_it_is_given(monkeypatch, tmp_path):
    """``build`` makes the directory before it looks for nvcc; without
    nvcc it raises its "nvcc not found" error."""
    target = tmp_path / "cache" / "kernels"
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(target))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("recon_fwd",))
    assert target.is_dir()


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _reference_parser(monkeypatch):
    """The parser ``dvae_tpu.cli.main`` builds, caught at parse time."""
    from dvae_tpu import cli as jcli
    from dvae_tpu.utils import tools as jtools

    def catch(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(jtools, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.delenv("DVAE_PLATFORM", raising=False)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as caught:
        jcli.main([])
    monkeypatch.undo()
    return caught.value.parser


def _subparsers(parser) -> dict:
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return dict(action.choices)
    raise AssertionError("no subcommands")


def _options(parser) -> dict:
    return {opt: action for action in parser._actions
            for opt in action.option_strings}


@pytest.mark.parametrize("cmd", ["train", "evaluate", "train-augmenter",
                                 "import-torch"])
def test_cli_knows_every_option_of_the_reference(cmd, monkeypatch):
    want = _options(_subparsers(_reference_parser(monkeypatch))[cmd])
    got = _options(_subparsers(tcli.build_parser())[cmd])
    missing = sorted(set(want) - set(got))
    assert not missing, f"{cmd}: the port lacks {missing}"
    for opt, action in want.items():
        # the same kind of option: a switch stays a switch, a choice keeps
        # the reference's choices
        assert type(got[opt]) is type(action), opt
        assert got[opt].choices == action.choices, opt


def _train_args(tmp_path, *extra):
    return ["train", "--device", "cpu", "--synthetic", "--syn_cells", "80",
            "--syn_genes", "24", "--syn_types", "4", "--n_categories", "4",
            "--n_arm", "2", "--fc_dim", "8", "--latent_dim", "4",
            "--batch_size", "32", "--n_epoch", "1", "--epochs_per_jit", "1",
            "--saving_folder", str(tmp_path) + "/", *extra]


@pytest.mark.parametrize("extra", [
    ["--sharding", "full"], ["--sharding", "ddp"],
    ["--mesh_data", "2"], ["--mesh_arm", "2"], ["--mesh_fsdp", "2"],
    ["--coordinator", "localhost:1234"], ["--num_processes", "2"],
    ["--process_id", "0"]],
    ids=lambda e: " ".join(e))
def test_cli_train_refuses_what_is_not_ported(extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tcli.main(_train_args(tmp_path, *extra))
    assert not os.listdir(tmp_path)  # refused before anything was written


@pytest.mark.parametrize("cmd", ["train", "evaluate"])
@pytest.mark.parametrize("extra", [["--toml", "dvae.toml"],
                                   ["--dataset", "mouse_smartseq"],
                                   ["--n_gene", "100"]],
                         ids=lambda e: e[0])
def test_cli_takes_the_dataset_flags(cmd, extra, tmp_path, monkeypatch):
    """``--toml``/``--dataset``/``--n_gene`` are taken, with or without
    ``--synthetic``; where the TOML names no file that exists the dataset
    is the synthetic one, as in ``dvae_tpu.cli``."""
    monkeypatch.chdir(tmp_path)
    argv = ([cmd, "--device", "cpu", *extra] if cmd == "train"
            else [cmd, "--device", "cpu", "--ckpt", "none.ckpt", *extra])
    for more in ([], ["--synthetic"]):
        args = tcli.build_parser().parse_args(
            argv + more + ["--syn_cells", "20", "--syn_genes", "6"])
        tcli._refuse_unported(args)
        ds = tcli._load_dataset(args)
        assert ds.log1p.shape == (20, 6)


def test_cli_train_streams(tmp_path, monkeypatch):
    """``train --stream`` reaches the trainer: the dataset stays on the
    host and the checkpoint records the mode."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(_train_args(tmp_path, "--stream")) == 0
    ckpts = sorted(tmp_path.glob("*/cpl_mixVAE_model_epoch_1.ckpt"))
    assert len(ckpts) == 1
    _, meta = tckpt.load_checkpoint(str(ckpts[0]))
    assert meta["tcfg"]["stream"] is True


def test_cli_train_takes_rng_impl_rbg(tmp_path, monkeypatch):
    """``--rng_impl rbg``, which ``dvae_tpu.cli train`` takes (fault C9):
    one epoch trains on the CPU and the checkpoint records the name."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(_train_args(tmp_path, "--rng_impl", "rbg")) == 0
    ckpts = sorted(tmp_path.glob("*/cpl_mixVAE_model_epoch_1.ckpt"))
    assert len(ckpts) == 1
    _, meta = tckpt.load_checkpoint(str(ckpts[0]))
    assert meta["tcfg"]["rng_impl"] == "rbg"


def test_cli_train_takes_wandb(tmp_path, monkeypatch, capsys):
    """``--wandb``, which ``dvae_tpu.cli train`` takes: without wandb
    installed the logger says so in one line and one epoch trains
    locally, as in the JAX package."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    assert tcli.main(_train_args(tmp_path, "--wandb")) == 0
    assert "falling back to local logging" in capsys.readouterr().out
    ckpts = sorted(tmp_path.glob("*/cpl_mixVAE_model_epoch_1.ckpt"))
    assert len(ckpts) == 1


def test_cli_train_passes_the_ported_model_flags(tmp_path, monkeypatch):
    """``--variational`` (type=bool as in the reference: an empty value is
    False), ``--local_bn_stats`` and the default ``--rng_impl`` reach the
    trainer and its checkpoint."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(_train_args(tmp_path, "--variational", "",
                                 "--local_bn_stats", "--rng_impl",
                                 "threefry2x32", "--sharding", "no")) == 0
    ckpts = sorted(tmp_path.glob("*/cpl_mixVAE_model_epoch_1.ckpt"))
    assert len(ckpts) == 1
    _, meta = tckpt.load_checkpoint(str(ckpts[0]))
    assert meta["cfg"]["variational"] is False
    assert meta["cfg"]["bn_groups"] == 1
    assert meta["tcfg"]["rng_impl"] == "threefry2x32"


def test_cli_evaluate_takes_the_model_flags_and_batch_size(tmp_path,
                                                           monkeypatch):
    """The reference's ``evaluate`` command line, model flags and
    ``--batch_size`` included, serves a checkpoint the port trained."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(_train_args(tmp_path)) == 0
    ckpt = str(sorted(tmp_path.glob("*/cpl_mixVAE_model_epoch_1.ckpt"))[0])
    assert tcli.main(["evaluate", "--device", "cpu", "--ckpt", ckpt,
                      "--synthetic", "--syn_cells", "40", "--syn_genes",
                      "24", "--syn_types", "4", "--n_arm", "2",
                      "--n_categories", "4", "--fc_dim", "8", "--latent_dim",
                      "4", "--loss_mode", "MSE", "--variational", "1",
                      "--batch_size", "16", "--p_drop", "0.5",
                      "--out_dir", str(tmp_path / "evaluation")]) == 0
    assert (tmp_path / "evaluation" / "A2-RUN0-E0.npy").exists()


# ---------------------------------------------------------------------------
# The package's top level against the JAX package's (fault C12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CplMixVAE", "mixvae_loss", "LossOutputs",
                                  "MixVAEOutputs", "apply", "init_params",
                                  "init_bn_state", "generate", "load_vae"])
def test_top_level_names_are_the_port_modules_objects(name):
    """Every lazy name of ``dvae_tpu`` resolves on the port to the object
    of the port's module of the same name (identity), without JAX."""
    import importlib

    import dvae_tpu
    import dvae_tpu_torch
    assert name in dvae_tpu._LAZY
    jmod, attr = dvae_tpu._LAZY[name]
    port_mod = importlib.import_module(jmod.replace("dvae_tpu.",
                                                    "dvae_tpu_torch.", 1))
    assert getattr(dvae_tpu_torch, name) is getattr(port_mod, attr)
    with pytest.raises(AttributeError):
        getattr(dvae_tpu_torch, name + "_missing")


def test_top_level_covers_the_jax_lazy_table_and_version():
    import dvae_tpu
    import dvae_tpu_torch
    assert sorted(dvae_tpu_torch._LAZY) == sorted(dvae_tpu._LAZY)
    assert dvae_tpu_torch.__version__ == dvae_tpu.__version__
