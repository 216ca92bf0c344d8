"""The port's multi-process runtime (vclust_tpu_torch/parallel/distributed.py).

Spawns 2 OS processes, each a member of one gloo process group over
localhost with 2 CPU shards (a global mesh of 4). Each runs
`python -m vclust_tpu_torch.parallel.worker`: the sharded prefilter
counts, the dense sharded products and the sharded device align engine
with records, gathered across the processes and held bit for bit against
its own one-process results, then prints MULTIHOST_OK.
"""

import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_two_processes_match_one_process():
    port = _free_port()
    nprocs = 2
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ)
        env.update(VCLUST_DIST_COORD=f'127.0.0.1:{port}',
                   VCLUST_DIST_NPROCS=str(nprocs),
                   VCLUST_DIST_PROCID=str(pid), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS='1')
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'vclust_tpu_torch.parallel.worker',
             '--device', 'cpu', '--shards', '2', '--timeout', '60'],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f'worker {pid} failed:\n{err[-4000:]}'
        assert f'MULTIHOST_OK pid={pid}/2 shards=4' in out, out
