"""Trips of the masked loop per batched call, ``parallel/batch.py``: K4 launches (one a trip) over calls."""


def read(ctx):
    trips = ctx.launches.get("fused_riccati_batched", 0)
    calls = ctx.work.get("calls", 0)
    return trips / calls if trips and calls else None
