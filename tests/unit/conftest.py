"""Build the JAX package's native host libraries once, before any unit test
module is imported.

`tetraear_tpu.utils.native_dsp.get_lib()` and `tetraear_tpu.crypto.native.
get_lib()` run `make` straight into `native/` the first time they are
called, and `test_native_dsp.py` / `test_native_crypto.py` call them at
module level.  Under pytest-xdist every worker collects every file, so
several workers would build at once; `g++ -o` is not atomic, and a worker
that loads a half-written library caches None and skips the file's tests.

This conftest is imported at collection time in every worker, before the
test modules of this directory.  It holds an exclusive lock on a file
under the ignored `build/` while it calls both loaders: the first worker
builds, the others wait and then load a whole file.
"""

import fcntl
from pathlib import Path

_LOCK = Path(__file__).resolve().parents[2] / "build" / "native-build.lock"


def _load_native_libs() -> None:
    from tetraear_tpu.crypto import native
    from tetraear_tpu.utils import native_dsp
    _LOCK.parent.mkdir(parents=True, exist_ok=True)
    with _LOCK.open("a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            native_dsp.get_lib()
            native.get_lib()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


_load_native_libs()
