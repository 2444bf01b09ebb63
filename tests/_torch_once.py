"""``once(tmp_path_factory, key, compute)``: ``compute()`` once for the
whole test run.  Under pytest-xdist the first worker to claim ``key``
computes it into the run's shared directory (a pickle this run wrote)
and the others wait for it and read it, so a spawned multi-rank run
serves every test that reads it, whichever worker each lands on."""
import os
import pickle
import time

import pytest


def once(tmp_path_factory, key: str, compute, timeout_s: float = 600):
    d = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        d = d.parent                       # shared by this run's workers
    d = d / "torch_once"
    d.mkdir(exist_ok=True)
    out, done = d / f"{key}.pkl", d / f"{key}.done"
    try:
        os.close(os.open(d / f"{key}.claimed", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        deadline = time.monotonic() + timeout_s
        while not done.exists():
            if time.monotonic() > deadline:
                pytest.fail(f"no result for {key}")
            time.sleep(0.1)
    else:
        try:
            out.write_bytes(pickle.dumps(compute()))
        finally:
            done.touch()
    if not out.exists():
        pytest.fail(f"computing {key} failed in another worker")
    return pickle.loads(out.read_bytes())
