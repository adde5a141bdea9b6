"""Host seconds of the model's frozen state, by part summed
(``Simulation.setup_seconds``: plans, supernode inverses, factored
channels, two-level factors); nothing where the model builds none (a
lattice)."""


def read(ctx):
    parts = ctx.setup_parts
    return sum(parts.values()) if parts else None
