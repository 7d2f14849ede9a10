import os
import sys

# Tests must see the real single CPU device; the 512-device override is
# exclusively dryrun.py's (the mandate forbids setting it globally).
assert "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", "")

# ---------------------------------------------------------------------------
# hypothesis fallback shim
#
# The property tests are written against hypothesis, but the bare CI
# interpreter does not ship it and the mandate forbids installing it.
# When the real library is absent we register a tiny deterministic stand-in
# that samples each strategy pseudo-randomly (seeded, so runs are
# reproducible) for ``max_examples`` iterations.  It covers exactly the
# API surface the suite uses: ``given``, ``settings``, ``strategies.floats
# / integers / sampled_from / composite``.
# ---------------------------------------------------------------------------

try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import random
    import types

    class _Strategy:
        def __init__(self, sample_fn):
            self._sample_fn = sample_fn

        def sample(self, rng):
            return self._sample_fn(rng)

    def _floats(min_value=0.0, max_value=1.0, **_kwargs):
        lo, hi = float(min_value), float(max_value)
        return _Strategy(lambda rng: rng.uniform(lo, hi))

    def _integers(min_value=0, max_value=1 << 30):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _sampled_from(elements):
        pool = list(elements)
        return _Strategy(lambda rng: pool[rng.randrange(len(pool))])

    def _composite(fn):
        def build(*args, **kwargs):
            return _Strategy(
                lambda rng: fn(lambda s: s.sample(rng), *args, **kwargs)
            )

        return build

    def _given(*strategies):
        def deco(fn):
            def wrapper(*args, **kwargs):
                rng = random.Random(0x5EED)
                # @settings may sit above @given (stamps the wrapper) or
                # below it (stamps the inner fn) — honor both orders
                n = getattr(
                    wrapper,
                    "_shim_max_examples",
                    getattr(fn, "_shim_max_examples", 10),
                )
                for _ in range(n):
                    drawn = tuple(s.sample(rng) for s in strategies)
                    fn(*args, *drawn, **kwargs)

            # NOTE: no functools.wraps — pytest would follow __wrapped__
            # and demand fixtures for the strategy-supplied parameters.
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco

    def _settings(max_examples=10, **_kwargs):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn

        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.floats = _floats
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _st.composite = _composite

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card and nvcc; skips (with its reason) elsewhere",
    )
