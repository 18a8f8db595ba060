"""Work that several test files share, done once a test session.

Under pytest-xdist each worker is a process of its own, so a module
fixture that two files use runs in each of them.  ``once`` keeps its
result in a directory of the session's temporary root, which every worker
of one session shares (pytest-xdist gives each worker a base directory
inside its controller's), and a file lock lets the first worker make it
while the others wait.  Without xdist the root is the session's own
base directory.
"""
import fcntl
import os
import pickle


def once(tmp_path_factory, name, make):
    """``make(directory)``'s value, computed once a session: the first
    call runs it in a new ``directory`` and pickles what it returns, later
    calls (from any worker) read that back."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = root / f"once-{name}"
    done = out / "value.pkl"
    with open(root / f"once-{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            out.mkdir(exist_ok=True)
            value = make(out)
            with open(out / "value.tmp", "wb") as f:
                pickle.dump(value, f)
            os.replace(out / "value.tmp", done)
    with open(done, "rb") as f:
        return pickle.load(f)
