"""mesh.mb_per_step: MB rank 0 received from the other ranks a step, from
the mesh's traffic record (``ParticleMesh.take_traffic``), mean over the
unprofiled window. Nothing without a mesh."""


def read(ctx):
    traffic = ctx["traffic"]
    if not traffic:
        return None
    received = sum(r["received"] for r in traffic.values())
    return received / 1e6 / ctx["window_steps"]
