"""The PyTorch port's SPMD launcher (``repro_torch/launch/spmd.py``) on the
CPU: bootstrap and the generation-counter barrier, the two-process
window demo on ``shm`` and ``socket`` (``--device cpu``), attr overrides
reaching the children, rank death reaping the group, the timeout killing
everything, the chaos-kill demo up to detection and drain — and one
mixed session, rank 0 running the reference and rank 1 the port over
shm: the wire contract end to end.  Every subprocess runs under its own
timeout.
"""
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from repro_torch.launch import spmd

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _env_without_spmd():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("REPRO_SPMD_", "REPRO_ATTR_"))}
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["SRC"] = SRC
    return env


def _launch(cmd, **kw):
    """``spmd.launch`` with the source tree on the children's path."""
    return spmd.launch(cmd, 2, env={
        "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "SRC": SRC}, **kw)


def _spmd(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.spmd", *args],
        env=_env_without_spmd(), capture_output=True, text=True,
        timeout=timeout)


class TestBootstrap:
    def test_requires_launcher_env(self, monkeypatch):
        monkeypatch.delenv(spmd.RANK_ENV, raising=False)
        with pytest.raises(RuntimeError, match="REPRO_SPMD_RANK"):
            spmd.bootstrap()

    def test_reads_launcher_env(self, monkeypatch, tmp_path):
        monkeypatch.setenv(spmd.RANK_ENV, "1")
        monkeypatch.setenv(spmd.NRANKS_ENV, "4")
        monkeypatch.setenv(spmd.SESSION_ENV, str(tmp_path))
        ctx = spmd.bootstrap()
        assert (ctx.rank, ctx.n_ranks, ctx.session) == (1, 4, str(tmp_path))


class TestBarrier:
    def test_two_ranks_meet(self, tmp_path):
        ctxs = [spmd.SpmdContext(r, 2, str(tmp_path)) for r in range(2)]
        errs = []

        def arrive(ctx):
            try:
                for _ in range(5):
                    ctx.barrier(timeout=20.0)
            except Exception as e:       # pragma: no cover - failure path
                errs.append(e)

        threads = [threading.Thread(target=arrive, args=(c,)) for c in ctxs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "barrier thread wedged"
        assert not errs
        for c in ctxs:
            c.close()

    def test_lone_rank_times_out(self, tmp_path):
        ctx = spmd.SpmdContext(0, 2, str(tmp_path))
        with pytest.raises(TimeoutError, match="barrier"):
            ctx.barrier(timeout=0.2)
        ctx.close()


def test_silence_declares_dead(tmp_path):
    """A rank that never beat is booting; one whose slot stops changing
    for longer than the timeout is dead; a new beat revives it."""
    me, peer = (spmd.SpmdContext(r, 2, str(tmp_path)) for r in range(2))
    assert me.dead_ranks(timeout=0.05) == []
    time.sleep(0.1)
    assert me.dead_ranks(timeout=0.05) == []
    peer.heartbeat()
    assert me.dead_ranks(timeout=0.05) == []
    time.sleep(0.1)
    assert me.dead_ranks(timeout=0.05) == [1]
    peer.heartbeat()
    assert me.dead_ranks(timeout=0.05) == []
    me.close()
    peer.close()


def _reference_beats(session, seconds):
    """A reference rank 1 heartbeating as fast as it can (its writer
    zero-fills the slot before each store)."""
    from repro.launch import spmd as ref_spmd
    ctx = ref_spmd.SpmdContext(1, 2, session)
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        ctx.heartbeat()
    ctx.close()


def test_live_reference_peer_never_read_dead(tmp_path):
    """A port rank whose reads race a reference rank's heartbeat writes
    (which zero-fill the slot first) never declares it dead."""
    session = str(tmp_path)
    me = spmd.SpmdContext(0, 2, session)
    me.heartbeat()
    proc = multiprocessing.get_context("spawn").Process(
        target=_reference_beats, args=(session, 1.5))
    proc.start()
    try:
        deadline = time.monotonic() + 30
        while me.peer_heartbeats()[1][0] == 0:
            assert time.monotonic() < deadline and proc.is_alive()
        reads = 0
        while proc.is_alive():
            assert me.dead_ranks(timeout=1.0) == []
            reads += 1
        assert reads > 1000
    finally:
        proc.join(timeout=30)
        assert not proc.is_alive()
        me.close()


def test_preflight_warns_and_proceeds(tmp_path, capsys):
    """A stale session dir is reported on stderr; the launcher goes on."""
    (tmp_path / "repro-spmd-stale").mkdir()
    (tmp_path / "other").mkdir()
    rep = spmd.preflight(roots=[str(tmp_path)])
    assert rep["stale_sessions"] == [str(tmp_path / "repro-spmd-stale")]
    assert not rep["clean"]
    assert "stale session dir" in capsys.readouterr().err


class TestLauncher:
    @pytest.mark.parametrize("backend", ["shm", "socket"])
    def test_two_process_window_demo(self, backend):
        out = _spmd("--ranks", "2", "--backend", backend, "--device", "cpu",
                    "--iters", "5", "--window", "16", "--timeout", "90")
        assert out.returncode == 0, out.stderr + out.stdout
        assert out.stdout.count("spmd-demo rank") == 2
        assert out.stdout.count("on cpu lost=0 leaked=0") == 2

    def test_attr_overrides_reach_children(self):
        probe = ("import os, sys; sys.path.insert(0, os.environ['SRC']); "
                 "from repro_torch.core import ProcessCluster; "
                 "from repro_torch.launch.spmd import bootstrap; "
                 "ctx = bootstrap(); "
                 "cl = ProcessCluster(2, ctx.rank, session=ctx.session, "
                 "device='cpu'); "
                 "assert cl.fabric.backend == 'shm', cl.fabric.backend; "
                 "assert cl.fabric.depth == 123, cl.fabric.depth; "
                 "assert cl.fabric.attr_source('fabric_depth') == 'env'; "
                 "cl.close()")
        assert _launch([sys.executable, "-c", probe], backend="shm",
                       attr_overrides={"fabric_depth": "123"},
                       timeout=60) == 0

    def test_rank_death_reaps_group_nonzero_exit(self):
        piddir = tempfile.mkdtemp(prefix="spmd-test-")
        victim = (
            "import os, subprocess, sys, time\n"
            "sys.path.insert(0, os.environ['SRC'])\n"
            "from repro_torch.launch.spmd import bootstrap\n"
            "ctx = bootstrap()\n"
            "ctx.barrier(timeout=30)\n"
            "if ctx.rank == 1:\n"
            "    os._exit(3)\n"
            "child = subprocess.Popen([sys.executable, '-c',\n"
            "                          'import time; time.sleep(600)'])\n"
            f"open(os.path.join({piddir!r}, 'grandchild'), 'w')"
            ".write(str(child.pid))\n"
            "while True:\n"
            "    time.sleep(0.1)\n")
        t0 = time.monotonic()
        try:
            code = _launch([sys.executable, "-c", victim], backend="shm",
                           timeout=60)
            assert code == 3
            assert time.monotonic() - t0 < 45
            pid_file = os.path.join(piddir, "grandchild")
            deadline = time.monotonic() + 10
            reaped = False
            while time.monotonic() < deadline and not reaped:
                if not os.path.exists(pid_file):
                    reaped = True
                    break
                try:
                    os.kill(int(open(pid_file).read()), 0)
                except ProcessLookupError:
                    reaped = True
                time.sleep(0.1)
            assert reaped, "grandchild survived the process-group teardown"
        finally:
            shutil.rmtree(piddir, ignore_errors=True)

    def test_timeout_kills_everything(self):
        t0 = time.monotonic()
        code = _launch([sys.executable, "-c", "import time; time.sleep(600)"],
                       backend="shm", timeout=2.0)
        assert code == 124
        assert time.monotonic() - t0 < 30

    def test_chaos_kill_detects_and_drains(self):
        """The launcher SIGKILLs rank 1 mid-stream: the survivor detects
        the silence, every outstanding post completes ERR_PEER_DEAD, none
        hangs, and it exits 0."""
        out = _spmd("--ranks", "2", "--device", "cpu", "--chaos-kill", "1",
                    "--kill-after", "0.5", "--hb-timeout", "3",
                    "--timeout", "90")
        text = out.stdout + out.stderr
        assert out.returncode == 0, text
        assert "chaos-kill SIGKILL rank 1" in text
        assert "spmd-chaos rank 0: drained" in text, text
        assert "other=0 hung=0" in text


MIXED = (
    "import os, sys\n"
    "sys.path.insert(0, os.environ['SRC'])\n"
    "if os.environ['REPRO_SPMD_RANK'] == '0':\n"
    "    from repro.launch import spmd\n"
    "    sys.exit(spmd._run_demo(16, 5, 64))\n"
    "from repro_torch.launch import spmd\n"
    "sys.exit(spmd._run_demo(16, 5, 64, 'cpu'))\n")


def test_mixed_session_reference_and_port():
    """Rank 0 runs the reference package, rank 1 the port, over shm:
    each rank's window demo reports nothing lost and nothing leaked."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import os, sys; sys.path.insert(0, os.environ['SRC']); "
         "from repro_torch.launch import spmd; "
         f"sys.exit(spmd.launch([sys.executable, '-c', {MIXED!r}], 2, "
         "backend='shm', timeout=90))"],
        env=_env_without_spmd(), capture_output=True, text=True,
        timeout=150)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("lost=0 leaked=0") == 2, r.stdout
    assert r.stdout.count("on cpu lost=0") == 1         # the port's rank
