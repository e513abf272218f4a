"""Multi-host runtime wiring (jax.distributed across hosts).

The reference is strictly single-process (SURVEY.md §2.3); this is the new
communication backend. One JAX process per host joins a coordination
service; `jax.devices()` then spans every host and `position_mesh()` builds
a process-spanning mesh. All cross-host traffic goes through XLA
collectives (the sweep's all_gathers/psums ride the device interconnect
within a host and the network across hosts); nothing else changes — the
sharded engine, ingest, and output paths are written against global
arrays.

Launch recipe (N hosts):

    # on every host, before anything touches jax devices:
    export HAMMLET_COORDINATOR=host0:8476     # any reachable host:port
    export HAMMLET_NUM_PROCESSES=N
    export HAMMLET_PROCESS_ID=<0..N-1>
    hammlet -f counts.csv -D 16 ...

HAMMLET_NUM_PROCESSES=auto leaves every unset field to
jax.distributed.initialize()'s own cluster detection (e.g. SLURM); with
no cluster environment all three variables must be given. CPU simulation
of an N-process run additionally sets
HAMMLET_LOCAL_DEVICES=<per-process device count> (see
tests/test_multihost.py, which runs a real 2-process mesh under pytest).
"""

from __future__ import annotations

import os


def initialize_from_env() -> bool:
    """Start the jax.distributed runtime if the environment asks for it.

    Reads HAMMLET_COORDINATOR / HAMMLET_NUM_PROCESSES / HAMMLET_PROCESS_ID
    (falling back to jax's own cluster auto-detection for unset fields).
    Must be called before any JAX backend use — the CLI calls it first
    thing. Returns True iff a multi-process runtime was initialized."""
    num = os.environ.get("HAMMLET_NUM_PROCESSES")
    if num is None:
        return False
    import jax

    local = os.environ.get("HAMMLET_LOCAL_DEVICES")
    if local is not None:
        # CPU simulation: per-process virtual device count (the
        # xla_force_host_platform_device_count flag does not apply to
        # multi-process CPU backends)
        jax.config.update("jax_num_cpu_devices", int(local))
    kwargs = {}
    coord = os.environ.get("HAMMLET_COORDINATOR")
    if coord is not None:
        kwargs["coordinator_address"] = coord
    if num != "auto":
        kwargs["num_processes"] = int(num)
    pid = os.environ.get("HAMMLET_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)
    return jax.process_count() > 1


def is_primary() -> bool:
    """True on the process that should write output files."""
    import jax

    return jax.process_index() == 0
