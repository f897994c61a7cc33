"""1 - device busy over wall, over the traced window of training steps."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
