"""Device busy a training step inside the traced call's first epoch, ms, as
``step_device_ms.xlsr`` reads it: from the first step's augment kernel to
the last step's, over (steps - 1). The Conformer call has no BN calibration
after its steps either (its BatchNorm1d statistics move inside them), so
the last step's own launch closes the stretch."""

from kwsbench.run import metric_reader

read = metric_reader("step_device_ms.xlsr")
