"""SIGINT under data-parallel training in the PyTorch port, on the CPU over
gloo: two processes of ``python -m deepclr_tpu_torch.training`` under the
``DEEPCLR_COORDINATOR`` contract, SIGINT to rank 0 alone after its first
micro-step of an 8-micro-step update.

The ranks agree on the interrupt at the end of an iteration (a MAX
all-reduce of the pending flag), so both stop after the same iteration,
well within 60 s (not after the process group's 10-minute timeout), and
rank 0's interrupt checkpoint holds the global batch's partial gradient:
the mean of the ranks' accumulators, as the JAX package's global
``grad_acc`` does.  It is held against one process of the global batch at
the same iteration (its periodic checkpoint there), within 1e-5 of each
gradient's scale, and resuming the two ranks from it gives the parameters
of that process resumed from its own checkpoint, within 1e-5 of the
model's scale (Ranger's first update: momentum only, so the two runs'
last-bit gradient differences stay last-bit differences)."""
import glob
import os
import os.path as osp
import signal
import time

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from .test_torch_parallel import GLOBAL_BATCH, _env, _free_port, _make_pack, _popen, _rank_env, _write_cfg  # noqa: E402

ACCUMULATION = 8        # micro-steps an update: an interrupt after micro-step 1..7 lands mid-update
ITERATIONS = 8          # one update
STOP_S = 60             # both ranks exit within this after the signal
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("dp_interrupt")
    _make_pack(ws / "train.pack")
    return ws


def _cfg(ws, run, batch_size):
    """The data-parallel test's YAML with Ranger, one update of 8
    micro-steps, a log line every micro-step and, for the reference, a
    checkpoint every micro-step (all kept)."""
    path = _write_cfg(ws, run, batch_size, checkpoint_period=1, name="Ranger", accumulation_steps=ACCUMULATION,
                      max_iterations=ITERATIONS)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["logging"].update(log_period=1, checkpoint_n_saved=ITERATIONS + 2)
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


def _run_dirs(base):
    return sorted(d for d in glob.glob(osp.join(base, "*")) if osp.isdir(d) and os.listdir(d))


def _run_dir(base):
    runs = _run_dirs(base)
    assert len(runs) == 1, runs
    return runs[0]


def _finish(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(i, p.returncode, out[-3000:]) for i, (p, out) in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not bad, bad
    return outs


def _weights(run_dir):
    return torch.load(osp.join(run_dir, "weights.pt"), weights_only=True)


def test_sigint_to_rank_0_stops_every_rank_with_the_global_gradient(ws):
    single = _cfg(ws, "single", GLOBAL_BATCH)
    two = _cfg(ws, "intr", GLOBAL_BATCH // 2)
    port = _free_port()
    reference = _popen(["-m", "deepclr_tpu_torch.training", single], _env())
    ranks = [_popen(["-m", "deepclr_tpu_torch.training", two], _rank_env(port, r)) for r in range(2)]
    head = []
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while time.monotonic() < deadline:
            line = ranks[0].stdout.readline()
            assert line, "rank 0 ended before its first micro-step:\n" + "".join(head[-40:])
            head.append(line)
            if "Iteration[1/" in line:
                break
        os.kill(ranks[0].pid, signal.SIGINT)
        signalled = time.monotonic()
        outs = _finish(ranks, STOP_S)
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
    assert time.monotonic() - signalled < STOP_S
    assert "KeyboardInterrupt. Stopping training." in "".join(head) + outs[0]
    _finish([reference], TIMEOUT_S)

    run = _run_dir(str(ws / "intr"))
    ckpt_path, = glob.glob(osp.join(run, "ckpt_interrupt_*.pt"))
    ckpt = torch.load(ckpt_path, weights_only=True)
    k = int(ckpt["iteration"])
    assert 1 <= k < ACCUMULATION, f"interrupted at iteration {k}: not inside the first update"
    assert ckpt["state"]["step"] == k

    # the global batch's partial gradient, and the (not yet updated) parameters
    ref_run = _run_dir(str(ws / "single"))
    ref_path = osp.join(ref_run, f"ckpt_{k}.pt")
    ref = torch.load(ref_path, weights_only=True)
    got_acc, want_acc = ckpt["state"]["grad_acc"], ref["state"]["grad_acc"]
    assert sorted(got_acc) == sorted(want_acc) and want_acc
    for name, g in want_acc.items():
        np.testing.assert_allclose(got_acc[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * max(1e-6, g.abs().max().item()), err_msg=name)
    for name, w in ref["state"]["model"].items():
        assert torch.equal(ckpt["state"]["model"][name], w), name

    # resumed from the interrupt checkpoint, the ranks end where one process
    # of the global batch resumed from its checkpoint at the same iteration ends
    port = _free_port()
    procs = [_popen(["-m", "deepclr_tpu_torch.training", single, "--ckpt", ref_path], _env())]
    procs += [_popen(["-m", "deepclr_tpu_torch.training", two, "--ckpt", ckpt_path], _rank_env(port, r))
              for r in range(2)]
    _finish(procs, TIMEOUT_S)
    resumed_ref = [r for r in _run_dirs(str(ws / "single")) if r != ref_run]
    resumed = [r for r in _run_dirs(str(ws / "intr")) if r != run]
    assert len(resumed_ref) == len(resumed) == 1, (resumed_ref, resumed)
    want, got = _weights(resumed_ref[0]), _weights(resumed[0])
    initial = ref["state"]["model"]
    scale = max(w.abs().max().item() for w in want.values())
    assert sorted(got) == sorted(want)
    assert any(not torch.equal(w, initial[name]) for name, w in want.items()), "the resumed runs never updated"
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)
