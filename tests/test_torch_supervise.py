"""The port's auto-resume supervisor (python -m graphsage_torch.supervise):
the five cases of tests/test_supervisor.py, on powerlaw:2000:10000 on the
CPU.  In the wedge case the supervised run's epochs also equal an unbroken
run's."""

import json
import os
import subprocess
import sys

from graphsage_torch import cli
from graphsage_torch.supervise import _newest_checkpoint

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _supervise(tmp_path, sup_args, cli_args, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    log = str(tmp_path / "events.jsonl")
    cmd = [sys.executable, "-m", "graphsage_torch.supervise", *sup_args,
           "--log", log, "--", *cli_args]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=600)
    events = []
    if os.path.exists(log):
        with open(log) as f:
            events = [json.loads(line) for line in f if line.strip()]
    return proc, events


def _epochs(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["event"], r["epoch"], r.get("mean_loss"), r.get("val_f1"))
            for r in recs if r["event"] in ("epoch", "eval")]


def test_survives_injected_wedge_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    sentinel = str(tmp_path / "wedge_fired")
    common = ["--dataSet", "powerlaw:2000:10000", "--epochs", "3",
              "--b_sz", "128", "--pipeline", "cached", "--table_cap", "8",
              "--device", "cpu", "--quiet", "--name", "sup"]
    proc, events = _supervise(
        tmp_path, ["--max_restarts", "2"],
        common + ["--checkpoint_dir", str(tmp_path / "ck"), "--metrics",
                  str(tmp_path / "m.jsonl")],
        {"GS_TEST_WEDGE_SENTINEL": sentinel})

    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert os.path.exists(sentinel), "the wedge never fired"
    kinds = [e["event"] for e in events]
    # child 1 wedged (rc 17) -> restart with --resume -> child 2 finished
    assert kinds == ["launch", "exit", "restart", "launch", "exit"], kinds
    assert events[1]["rc"] == 17
    assert events[2]["resume"] and "model_best_sup_ep0_" in events[2][
        "resume"]
    assert events[3]["cmd"][-2:] == ["--resume", events[2]["resume"]]
    assert events[4]["rc"] == 0
    assert "FATAL: injected test wedge" in proc.stdout
    assert "Best validation F1" in proc.stdout

    cli.run(common + ["--checkpoint_dir", str(tmp_path / "ck_unbroken"),
                      "--metrics", str(tmp_path / "unbroken.jsonl")])
    assert (_epochs(tmp_path / "m.jsonl")
            == _epochs(tmp_path / "unbroken.jsonl"))


def test_non_wedge_failure_is_not_restarted(tmp_path):
    # an argparse error exits 2: a real failure, surfaced at once
    proc, events = _supervise(tmp_path, [], ["--no_such_flag"])
    assert proc.returncode == 2
    assert [e["event"] for e in events] == ["launch", "exit"]


def test_bounded_restarts_give_up(tmp_path):
    """A child that wedges on every attempt exhausts max_restarts and the
    supervisor surfaces the wedge code (--wedge_rc 2 maps the argparse
    error to a wedge, for a child that always 'wedges')."""
    proc, events = _supervise(tmp_path, ["--max_restarts", "1",
                                         "--wedge_rc", "2"],
                              ["--no_such_flag"])
    assert proc.returncode == 2
    assert [e["event"] for e in events] == [
        "launch", "exit", "restart", "launch", "exit", "giving_up"]


def test_newest_checkpoint_scoped_by_run_name(tmp_path):
    """Only this run's checkpoints (model_best_<name>_) are resumed, never
    another run's newer one, nor a checkpoint writer's temporary."""
    ck = tmp_path / "ck"
    ck.mkdir()
    a = ck / "model_best_a_ep1_0.5000"
    b = ck / "model_best_b_ep7_0.9000"
    tmp = ck / ".tmp-123-model_best_a_ep2_0.6000"
    for path, t in ((a, 1000), (b, 2000), (tmp, 3000)):
        path.write_bytes(b"")
        os.utime(path, (t, t))
    assert _newest_checkpoint(str(ck), "a") == str(a)
    assert _newest_checkpoint(str(ck), "b") == str(b)
    assert _newest_checkpoint(str(ck), "c") is None
    assert _newest_checkpoint(str(tmp_path / "absent"), "a") is None


def test_wedge_before_first_checkpoint_preserves_user_resume(tmp_path):
    """A child that wedges before writing any checkpoint is relaunched
    with the operator's own --resume kept."""
    resume = "/prev/model_best_prod_ep40_0.93"
    proc, events = _supervise(tmp_path, ["--max_restarts", "1",
                                         "--wedge_rc", "2"],
                              ["--resume", resume, "--no_such_flag"])
    assert proc.returncode == 2
    restarts = [e for e in events if e["event"] == "restart"]
    assert restarts and all(e["resume"] == resume for e in restarts)
    relaunch = [e for e in events if e["event"] == "launch"][1]
    assert relaunch["cmd"][-2:] == ["--resume", resume] or (
        resume in relaunch["cmd"])
    assert relaunch["cmd"][2:4] == ["-m", "graphsage_torch.cli"]
