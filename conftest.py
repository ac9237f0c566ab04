"""Keeps the multi-controller demo subprocesses of ``tests/test_multihost.py``
from filling their stdout pipes.

That module starts pairs of elastic-demo controllers with stdout on a pipe
and reads the pipes one at a time.  The suite turns on JAX's persistent
compilation cache for every process it starts (``tests/conftest.py``), and
XLA:CPU logs two error lines of about 2.6 KB each for every executable it
loads back from that cache (a spurious machine-feature mismatch on its own
``+prefer-no-scatter``/``+prefer-no-gather`` tuning flags).  On a warm cache
the controller whose pipe is not being read fills it (64 KiB) and blocks,
and its sync-mode peer waits each step out until the test's own timeout
fails it.  For that module only, the controllers are started with XLA's
C++ logging cut to fatal lines; every other test runs as it would without
this file.
"""

import os

import pytest


@pytest.fixture(scope="module", autouse=True)
def _quiet_xla_in_multihost_demos(request):
    if request.module.__name__.rpartition(".")[2] != "test_multihost":
        yield
        return
    before = os.environ.get("TF_CPP_MIN_LOG_LEVEL")
    os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("TF_CPP_MIN_LOG_LEVEL", None)
        else:
            os.environ["TF_CPP_MIN_LOG_LEVEL"] = before
