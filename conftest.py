"""Build the JAX package's native libraries before the repo's tests are
collected.

``libhashcore.so`` and ``liblruindex.so`` are build products that git
ignores, so a fresh checkout lacks them: every test that needs them then
skips, and the tests parametrised over the native index are not collected at
all. Both loaders remember a failed first load, so the build has to come
before any test module is imported; ``tests/conftest.py`` loads neither.

Only a session that collects ``tests/`` builds them: ``perfbench/tests``
runs must not import the JAX package. Each xdist worker configures its own
session, and all of them take one lock, kept under the checkout's
git-ignored ``build/``: a library another worker is still writing exists
before it is whole. A failed build leaves those tests skipping, as they did
before.
"""

import fcntl
import os
import subprocess

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")


def _collects_tests(args) -> bool:
    for arg in args or [ROOT]:
        path = os.path.abspath(str(arg).split("::")[0])
        if path == TESTS or path.startswith(TESTS + os.sep) or TESTS.startswith(path + os.sep):
            return True
    return False


def _build_native_libraries() -> None:
    from llm_d_kv_cache_manager_tpu.native import build as native_build

    def missing() -> bool:
        return not all(os.path.exists(os.path.join(native_build.HERE, lib))
                       for lib in native_build.LIBS.values())

    if not missing():
        return
    lock_dir = os.path.join(ROOT, "build", "native")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if missing():
            try:
                native_build.build(verbose=False)
            except (OSError, subprocess.CalledProcessError):
                pass


def pytest_configure(config):
    if _collects_tests(config.args):
        _build_native_libraries()
