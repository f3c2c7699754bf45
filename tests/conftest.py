import os

# Tests see the real single CPU device; only launch/dryrun.py (run as its own
# process) forces 512 host devices. A couple of distributed tests spawn their
# own subprocess with a small device count.
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
