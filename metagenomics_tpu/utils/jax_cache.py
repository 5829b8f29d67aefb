"""Where the persistent XLA compilation cache lives.

JAX_COMPILATION_CACHE_DIR wins when it is set; otherwise the cache is the
fixed directory .jax_cache/ at the root of the checkout.  The path is part
of the cache key, so it must not move between runs for the cache to hit.
"""

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir(env=None):
    """The compilation cache directory for this environment mapping."""
    env = os.environ if env is None else env
    return env.get(CACHE_ENV) or DEFAULT_CACHE


def enable_compile_cache(env=None):
    """Point JAX's persistent compilation cache at compile_cache_dir();
    call before the first compilation.  Returns the directory."""
    import jax
    path = compile_cache_dir(env)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
