"""Full-length passes over the wavenumbers a search by find_g_points' two
per-wavenumber map builders: the port's counter
``partition.gas_data.map_counts()`` (one a g-point of each gas, one a
merged g-point and gas) over the run's searches, set-up's one and the
window's.  None where the port has no such counter or counted none.
Layer: partition: gas_data overlap and per-wavenumber maps.  Moves
search_s."""


def read(ctx):
    try:
        from ecckd_tpu_torch.partition.gas_data import map_counts
    except ImportError:
        return None
    passes = sum(map_counts().values())
    if not passes:
        return None
    return passes / (len(ctx.durations) + 1)
