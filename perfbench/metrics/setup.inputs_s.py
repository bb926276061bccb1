"""The entry's set-up less the SRS file's parse: the cell's inputs made or
read from the seed (the proof pool and its tampered copies, or the MSM's
bases and scalar vectors) and the program's objects built from them,
timed by the harness."""


def read(run):
    return run.spans.get("setup.inputs_s")
