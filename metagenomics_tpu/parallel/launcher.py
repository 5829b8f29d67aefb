"""Multi-host runtime initialization.

The reference has no distributed runtime at all — copyToServers.sh:1-3 just
scp's the binary to lab hosts for separate manual runs (SURVEY.md §2.3).
Here multi-host is first-class: one Python process per host, joined into a
single JAX runtime so every device of every host participates in one mesh
and the collectives run across hosts.

Usage (one of):
  * On clusters whose scheduler JAX can read (e.g. SLURM, or GPU hosts
    started by a launcher that sets JAX's own coordinator variables): set
    MGTPU_AUTODETECT=1 and ``initialize_distributed()`` lets
    jax.distributed.initialize() autodetect the coordinator and ranks.
  * Anywhere else: set MGTPU_COORDINATOR (host:port of process 0),
    MGTPU_NUM_PROCESSES, MGTPU_PROCESS_ID before launching each process.

After initialization, ``parallel.make_mesh`` builds the ("dp", "ix") mesh
over jax.devices() (which now spans all hosts) and the sharded overlap
pipeline (parallel/sharded.py) runs unchanged: shard_map gives each process
its local shard of the global arrays, and cross-host candidate merging uses
the same psum/all_gather collectives as the single-host multi-device path.
"""

import os


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None, log=print):
    """Join this process into a multi-host JAX runtime.

    Arguments default to the MGTPU_COORDINATOR / MGTPU_NUM_PROCESSES /
    MGTPU_PROCESS_ID environment variables; with none set (and no cloud
    autodetection available) this is a no-op so single-host runs need no
    configuration.  Returns True if a multi-process runtime was initialized.
    """
    import jax

    coordinator = coordinator or os.environ.get("MGTPU_COORDINATOR")
    num_processes = num_processes or os.environ.get("MGTPU_NUM_PROCESSES")
    process_id = process_id if process_id is not None \
        else os.environ.get("MGTPU_PROCESS_ID")

    if coordinator is None and num_processes is None:
        # cluster schedulers can supply the ranks, but a bare
        # initialize() BLOCKS waiting for peers in misconfigured setups —
        # so autodetection is opt-in; the default is single-process.
        if os.environ.get("MGTPU_AUTODETECT") != "1":
            return False
        jax.distributed.initialize()
        return jax.process_count() > 1

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(num_processes),
        process_id=int(process_id))
    log("metagenomics_tpu: joined distributed runtime as process %d/%d "
        "(%d local / %d global devices)"
        % (jax.process_index(), jax.process_count(),
           jax.local_device_count(), jax.device_count()))
    return True
