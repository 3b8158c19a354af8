"""Both packages' native host coders, loaded in every test worker.

``rav1e_tpu/native.py`` builds ``native/librav1e_tpu_ec.so`` in place at
first use, without a lock.  Test workers reach it together, while they
collect (``test_deblock_native.py``, ``test_native_parity.py`` and
``test_native_tile.py`` ask for it at import), and each runs g++ on that one
file.  A worker that loads the library while another worker's linker writes
it anew gets a load error, which that loader answers by taking the Python
coders for the rest of the process without a word: the worker's encodes
then skip the device chain, and a test that compares packets fails on a
mismatch that has nothing to do with the code it tests.

The port's test modules that need the coders call :func:`build` when they
are imported, later in the same collection.  Under a lock on a file, one
worker at a time builds or loads both libraries; where the reference's
loader gave up on a library that is there and matches its sources, it is
asked again until the other workers' linkers are done.  :func:`require`
then says in a test that both loaded, so that a fallback shows as its own
error.
"""

import fcntl
import threading
import time
from pathlib import Path

LOCK = Path(__file__).resolve().parent.parent / "build" / "native_libs.lock"
RELOAD_TRIES = 60  # one a second: a concurrent g++ build takes about 20 s


def _loaders():
    import rav1e_tpu.native
    import rav1e_tpu_torch.native

    return {"rav1e_tpu": rav1e_tpu.native.get_lib,
            "rav1e_tpu_torch": rav1e_tpu_torch.native.get_lib}


def _reload_reference():
    """Load the reference's library again where its loader gave up on a
    built one (its sources' hash beside it): the load raced a linker."""
    from rav1e_tpu import native as ref

    for _ in range(RELOAD_TRIES):
        if ref.get_lib() is not None:
            return
        built = (ref._LIB.exists() and ref._HASH.exists()
                 and ref._HASH.read_text().strip() == ref._src_hash())
        if not built:
            return  # the build failed: nothing to load
        time.sleep(1.0)
        ref._tried = False


def build() -> None:
    """Build (or load) both libraries, one process at a time; the two
    builds run side by side."""
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        threads = [threading.Thread(target=get) for get in _loaders().values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _reload_reference()


def require() -> None:
    """Fail unless both libraries loaded in this process."""
    missing = [name for name, get in _loaders().items() if get() is None]
    assert not missing, (
        f"the native host coder of {', '.join(missing)} did not build or "
        "load: its encodes fall back to the Python coders and skip the "
        "device chain")
