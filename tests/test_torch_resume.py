"""The port's CLI with --config, --checkpoint_dir and --resume, and its exit
on a wedged fetch, on the CPU: the mirrors of tests/test_config.py's CLI
cases (end to end, resume then export, the wedged fetch), with the
checkpoint's name held to the JAX package's."""

import json
import os
import re

import numpy as np
import pytest

import graphsage_torch.train.trainer as trainer_mod
from graphsage_torch import cli, infer
from graphsage_torch.convert import flatten_params
from graphsage_torch.utils.checkpoint import restore_checkpoint
from graphsage_torch.utils.obs import FetchDeadlineError

BASE = ["--dataSet", "powerlaw:200:800", "--b_sz", "32", "--fanout", "4",
        "--seed", "3", "--device", "cpu", "--quiet"]


@pytest.mark.parametrize("flags,layers,hidden", [
    ([], 3, 12),
    (["--num_layers", "1"], 1, 12),
    (["--hidden", "6"], 3, 6),
], ids=["config", "num_layers_flag", "hidden_flag"])
def test_config_sets_layers_and_hidden(tmp_path, flags, layers, hidden):
    conf = tmp_path / "exp.conf"
    conf.write_text("setting {\n  num_layers = 3\n  hidden_emb_size = 12\n"
                    "}\n")
    trainer, _ = cli.run(BASE + ["--epochs", "1", "--config", str(conf),
                                 "--checkpoint_dir", str(tmp_path / "ck"),
                                 *flags])
    assert trainer.mcfg.num_layers == layers
    assert trainer.mcfg.out_size == hidden
    assert len(trainer.params["sage"]["layers"]) == layers


def test_defaults_without_config(tmp_path):
    trainer, _ = cli.run(BASE + ["--epochs", "1", "--checkpoint_dir",
                                 str(tmp_path / "ck")])
    assert (trainer.mcfg.num_layers, trainer.mcfg.out_size) == (2, 128)


def test_cli_checkpoints_under_the_jax_name(tmp_path):
    """Every val improvement writes model_best_<name>_ep<E>_<testF1:.4f>
    (the JAX CLI's name) under --checkpoint_dir, holding the best-val
    snapshot, the epoch, the best F1 and the RandomState."""
    metrics = tmp_path / "m.jsonl"
    trainer, best = cli.run(BASE + [
        "--epochs", "2", "--hidden", "16", "--name", "run1",
        "--checkpoint_dir", str(tmp_path / "ck"), "--metrics",
        str(metrics)])
    tests = [json.loads(line) for line in metrics.read_text().splitlines()
             if json.loads(line)["event"] == "test"]
    want = sorted(f"model_best_run1_ep{r['epoch']}_{r['test_f1']:.4f}"
                  for r in tests)
    assert sorted(os.listdir(tmp_path / "ck")) == want and want
    assert all(re.fullmatch(r"model_best_run1_ep\d+_\d\.\d{4}", n)
               for n in want)
    newest = tmp_path / "ck" / f"model_best_run1_ep{best['epoch']}_" \
        f"{best['test_f1']:.4f}"
    params, epoch, best_f1, _ = restore_checkpoint(str(newest),
                                                   trainer.params)
    assert epoch == best["epoch"] and best_f1 == trainer.max_vali_f1
    got, want_p = flatten_params(params), flatten_params(best["params"])
    for key in want_p:
        np.testing.assert_array_equal(got[key], want_p[key])


def test_cli_resume_then_export(tmp_path):
    """--resume followed by --export: the run continues after the
    checkpointed epoch, and the bundle ships the best-val params, the
    checkpoint's own when the resumed epochs do not improve on it."""
    ck = tmp_path / "ck"
    cli.run(BASE + ["--epochs", "1", "--hidden", "16", "--checkpoint_dir",
                    str(ck)])
    (name,) = os.listdir(ck)
    bundle = str(tmp_path / "bundle")
    trainer, best = cli.run(BASE + [
        "--epochs", "3", "--hidden", "16", "--checkpoint_dir", str(ck),
        "--resume", str(ck / name), "--export", bundle,
        "--metrics", str(tmp_path / "m.jsonl")])
    assert [h["epoch"] for h in trainer.history] == [1, 2]
    events = [json.loads(line)["event"]
              for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert events[0] == "resume"
    params, _, _, meta = infer.load_bundle(bundle)
    assert meta["params"] == "best-val"
    assert meta["epoch"] == best["epoch"] and meta["test_f1"] is not None
    got, want = flatten_params(params), flatten_params(best["params"])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    if best["epoch"] == 0:      # no improvement after the resume
        ck_params, _, _, _ = restore_checkpoint(str(ck / name),
                                                trainer.params)
        for key, value in flatten_params(ck_params).items():
            np.testing.assert_array_equal(got[key], value)


def test_cli_wedged_fetch_exits_loudly(monkeypatch, capsys, tmp_path):
    """A FetchDeadlineError out of fit makes the CLI print FATAL and
    os._exit(17), skipping the interpreter's teardown."""
    def wedged_fit(self):
        raise FetchDeadlineError("step 400 loss fetch did not complete")

    monkeypatch.setattr(trainer_mod.Trainer, "fit", wedged_fit)
    codes = []
    monkeypatch.setattr(cli.os, "_exit", lambda c: codes.append(c))
    cli.main(BASE + ["--epochs", "1", "--hidden", "16", "--checkpoint_dir",
                     str(tmp_path / "ck")])
    assert codes == [17] == [cli.WEDGE_EXIT]
    out = capsys.readouterr().out
    assert ("FATAL: step 400 loss fetch did not complete; restart and "
            "resume from the last checkpoint") in out


def test_cli_checkpoint_write_failure_keeps_training(tmp_path, capsys):
    """A checkpoint that cannot be written is reported, and training goes
    on."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    trainer, best = cli.run(BASE + ["--epochs", "2", "--hidden", "8",
                                    "--checkpoint_dir", str(blocker)])
    assert [h["epoch"] for h in trainer.history] == [0, 1]
    assert best["params"] is not None
    assert "checkpoint failed" in capsys.readouterr().out
