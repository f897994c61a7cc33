"""Device ms a step under the ``siren.batchnorm`` spans: the plain trunk's
BatchNorm forward in training mode (batch statistics, running update,
normalisation); autograd's backward of it lies under no such span."""

from portbench.readers import ms_a_step_under

SPANS = True       # reads the program's spans: on in this cell's traced runs


def read(run):
    return ms_a_step_under(run, "siren.batchnorm")
