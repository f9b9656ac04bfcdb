"""WITCH-TPU: a JAX re-implementation of WITCH (WeIghTed Consensus Hmm
alignment; reference: c5shen/WITCH). Profile-HMM construction, Forward
scoring, posterior-OA alignment, and the weighted merge all run as batched
array programs instead of the reference's subprocess farm."""

import os

__version__ = "0.1.0"

# Persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed path (the path is part of the cache key), gitignored.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def configure_jax():
    """Compile-cache placement and one start-up line naming the device.

    The platform is whatever JAX reports: JAX_PLATFORMS decides. When
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here."""
    import sys

    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    devs = jax.devices()
    sys.stderr.write("witch-tpu: platform %s, device %s, %d device(s)\n"
                     % (devs[0].platform, devs[0].device_kind, len(devs)))


def witch_runner(argv=None):
    import sys
    import time

    configure_jax()

    cmdline_args = sys.argv[1:] if argv is None else argv

    from .cli import init_parser
    from .config import Configs, build_configs
    from .pipeline import main_alignment_process

    parser = init_parser()
    build_configs(parser, cmdline_args)
    Configs.log("WITCH-TPU is running with: {}".format(
        " ".join(cmdline_args)))
    s1 = time.time()
    out = main_alignment_process()
    s2 = time.time()
    Configs.log("WITCH-TPU finished in {} seconds...".format(s2 - s1))
    print("\nAll done! WITCH-TPU finished in {:.1f} seconds...".format(
        s2 - s1))
    return out
