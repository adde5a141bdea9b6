"""A reference computed once a test session and shared by the ``pytest -n``
workers: the first worker that asks for ``key`` computes it under a file
lock in the session's temporary directory and leaves it there pickled;
a worker that asks later waits on the lock and reads it.  A module-scoped
fixture alone computes it once a worker, and the cases of one
parametrised test land on several workers.

``value`` must pickle (numpy arrays, numbers, lists, dicts)."""

import fcntl
import os
import pickle


def session_dir(tmp_path_factory):
    """The directory every worker of this session shares."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def once(tmp_path_factory, key, compute):
    """``compute()`` for ``key``, computed by one worker of the session."""
    base = session_dir(tmp_path_factory)
    path = base / f"once-{key}.pickle"
    with open(base / f"once-{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return pickle.loads(path.read_bytes())
        value = compute()
        part = base / f"once-{key}.part"
        part.write_bytes(pickle.dumps(value))
        os.replace(part, path)
        return value
