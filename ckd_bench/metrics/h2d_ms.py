"""Device milliseconds per table of copies from the host to the card
(``Memcpy HtoD`` in the trace): the spectra's blocks and the tables the
port uploads.  Layer: ops/ and io/ copies to the card.  Moves lut_s."""


def read(ctx):
    secs = ctx.device_seconds(lambda n: "HtoD" in n)
    if secs == 0.0:
        return None
    return 1e3 * secs / len(ctx.durations)
