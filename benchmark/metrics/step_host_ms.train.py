"""The median host time of a replayed training step in the traced
sub-window, ms: the port's ``train.step`` spans of kind ``replay``
(``training._GraphEpoch``: the step seed, the batch gather, the re-seeds
and seed words, the graph's replay). Against the device's time a step it
says whether the host keeps a step queued."""

from benchmark import port_spans


def read(prof):
    return port_spans.step_host_ms(prof)
