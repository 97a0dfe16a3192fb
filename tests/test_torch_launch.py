"""The port's serving launcher (``python -m repro_torch.launch.serve``):
``main(argv)`` on smoke granite-3-2b on the CPU for a plain run, the
failover drill (statuses and counters held against the reference
launcher's run of the same argv), the crash drill, the page-corruption
drill and a traced run whose export validates and cross-checks; the MoE
and MLA families through both launchers.  Every file goes to a temporary
directory."""
import ast
import json
import math
import weakref

import pytest
import torch

from repro.launch import serve as ref_launch
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.obs import export
from repro_torch.serve import Engine

torch.set_num_threads(1)

SMALL = ["--smoke", "--requests", "6", "--max-seq", "64", "--slots", "2",
         "--page-size", "4", "--max-new", "12"]
PORT = SMALL + ["--device", "cpu"]
FAILOVER = ["--replicas", "2", "--kill-replica", "1", "--kill-at-step", "2",
            "--mixed-lengths"]


def _line(out, prefix):
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert lines, f"no {prefix!r} line in:\n{out}"
    return lines[-1]


def _statuses(out):
    return ast.literal_eval(_line(out, "request status:").split(":", 1)[1])


def test_a_plain_run_serves_every_request(capsys):
    assert launch.main(PORT) == 0
    out = capsys.readouterr().out
    assert _statuses(out) == {"ok": 6}
    assert "all done: True" in out
    assert "fused decode:" in out and "paging: high-water" in out


def test_the_failover_drill_matches_the_reference_launcher(capsys, tmp_path):
    """Replica 1 dies at its decode step 2; its request migrates.  The
    launchers' wall clocks drive the restart backoff and the watchdog, so
    the runs are held to the counts that do not depend on them."""
    runs = []
    for main, extra in ((ref_launch.main, []), (launch.main,
                                                ["--device", "cpu"])):
        path = tmp_path / f"m{len(runs)}.json"
        assert main(SMALL + FAILOVER + extra
                    + ["--metrics-json", str(path)]) == 0
        out = capsys.readouterr().out
        runs.append((_statuses(out), json.loads(path.read_text()), out))
    (ref_status, ref_st, _), (status, st, out) = runs
    assert status == ref_status == {"ok": 6}
    keys = ("replica_faults", "migrations", "retries_exhausted", "shed",
            "drains", "completed", "failed", "requests", "n_replicas")
    assert {k: st[k] for k in keys} == {k: ref_st[k] for k in keys}
    assert st["replica_faults"] == 1 and st["migrations"] >= 1
    assert "router: 2 replicas" in out


@pytest.mark.parametrize("replicas", ["1", "2"])
def test_the_crash_drill_restores_and_finishes(capsys, tmp_path, replicas,
                                               monkeypatch):
    """The killed process's engines are all collected before the rebuilt
    ones are made (on the card: their caches and decode graphs go back),
    and every restored request finishes."""
    made, alive = [], []
    init, release = Engine.__init__, launch._release

    def recording_init(self, *args, **kw):
        init(self, *args, **kw)
        made.append(weakref.ref(self))

    def counting_release():
        release()
        alive.append(sum(ref() is not None for ref in made))

    monkeypatch.setattr(Engine, "__init__", recording_init)
    monkeypatch.setattr(launch, "_release", counting_release)
    argv = PORT + ["--replicas", replicas, "--kv-integrity",
                   "--snapshot-every", "1", "--snapshot-dir",
                   str(tmp_path / "snaps"), "--kill-process-at", "6"]
    assert launch.main(argv) == 0
    assert alive == [0] and len(made) == 2 * int(replicas)
    out = capsys.readouterr().out
    assert "process killed" in out
    drill = _line(out, "crash drill: restored")
    assert drill.endswith(" 0 not ok") and " 0 completed ok" not in drill
    assert set(_statuses(out)) <= {"ok", "preempted_1"}
    assert (tmp_path / "snaps" / "LATEST").exists()


def test_the_page_corruption_drill_quarantines_one_page(capsys):
    assert launch.main(PORT + ["--kv-integrity", "--corrupt-page", "1"]) == 0
    out = capsys.readouterr().out
    assert " 1 pages quarantined" in _line(out, "integrity:")
    assert " 0 failed" in _line(out, "overload:")
    assert sum(_statuses(out).values()) == 6


def test_a_traced_failover_run_exports_a_valid_trace(capsys, tmp_path):
    trace_path, metrics_path = tmp_path / "t.json", tmp_path / "m.json"
    assert launch.main(PORT + FAILOVER + ["--trace-out", str(trace_path),
                                          "--metrics-json",
                                          str(metrics_path)]) == 0
    out = capsys.readouterr().out
    doc = json.loads(trace_path.read_text())
    stats = json.loads(metrics_path.read_text())
    assert export.validate_chrome_trace(doc) == []
    assert export.cross_check_counters(doc, stats) == []
    assert any(ev["name"] == "decode.dispatch" and ev["ph"] == "B"
               for ev in doc["traceEvents"])
    assert "migrate×1" in _line(out, "trace events:")
    assert _line(out, "trace written to").startswith(
        f"trace written to {trace_path}")


def test_the_serve_launcher_runs_granite_moe(capsys):
    assert launch.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                        "--device", "cpu", "--requests", "4",
                        "--max-seq", "64"]) == 0
    out = capsys.readouterr().out
    assert _statuses(out) == {"ok": 4}
    assert "all done: True" in out
    assert _line(out, "percentiles:").startswith("percentiles: queue_s")


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_the_launchers_run_the_recurrent_families(capsys, arch):
    """``launch/serve.py`` with its failover drill on two replicas, and
    ``launch/train.py``, at each recurrent family's smoke size."""
    assert launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-seq", "64",
                        "--replicas", "2", "--kill-replica", "1",
                        "--kill-at-step", "2"]) == 0
    out = capsys.readouterr().out
    assert _statuses(out) == {"ok": 4}
    assert "all done: True" in out
    tr, _ = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                               "--steps", "2", "--seq", "16", "--batch",
                               "4"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"done: 2 steps, final loss {tr.history[-1]['loss']:.4f}"


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_the_train_launcher_runs_the_frontend_families(capsys, arch):
    """``launch/train.py --sparse-ffn`` at the encoder-decoder family's and
    the vision frontend's smoke sizes, losses finite; ``launch/serve.py``
    admits tokens alone, as the reference's, and refuses both configs by
    name."""
    tr, _ = launch_train.main(["--arch", arch, "--smoke", "--sparse-ffn",
                               "--device", "cpu", "--steps", "2", "--seq",
                               "16", "--batch", "4"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"done: 2 steps, final loss {tr.history[-1]['loss']:.4f}"
    assert all(math.isfinite(h["loss"]) for h in tr.history)
    assert (tr.model.encoder is not None) == (arch == "seamless-m4t-medium")
    with pytest.raises(ValueError, match="tokens alone"):
        launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "2", "--max-seq", "64"])


def test_the_train_launcher_runs_deepseek_v3(capsys):
    tr, _ = launch_train.main(["--arch", "deepseek-v3-671b", "--smoke",
                               "--device", "cpu", "--steps", "2", "--seq",
                               "16", "--batch", "4"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"done: 2 steps, final loss {tr.history[-1]['loss']:.4f}"
    for h in tr.history:
        assert {"ce", "load_balance", "mtp", "loss", "grad_norm"} <= set(h)
    assert tr.model.mtp is not None
