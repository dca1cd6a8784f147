"""Multi-process training and predict for the port (``dist_train``).

- ``distributed.py`` bring-up: ``torch.distributed`` over a TCP
                     rendezvous at worker_hosts[0]'s port + 1000, gloo.
- ``liveness.py``    heartbeat leases and the collective deadline guard.
- ``sharded.py``     the process group as the mesh: row shards, host
                     collectives, lockstep scoring.
"""
