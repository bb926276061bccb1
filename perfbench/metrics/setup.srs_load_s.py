"""The SRS file's parse at set-up (`sdk.srs.load_params`, its python-int
point decompression), timed by the harness around the call."""


def read(run):
    return run.spans.get("setup.srs_load_s")
