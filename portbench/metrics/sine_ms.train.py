"""Device ms a step under the ``siren.sine`` spans: the SIREN layers' sine,
forward and backward, and the cast to the compute dtype in its
launch."""

from portbench.readers import ms_a_step_under

SPANS = True       # reads the program's spans: on in this cell's traced runs


def read(run):
    return ms_a_step_under(run, "siren.sine")
