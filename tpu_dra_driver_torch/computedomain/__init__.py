"""The port's own copy of what its multi-device dryrun needs from the
control plane's ComputeDomain code: the multislice bootstrap env
(:mod:`.multislice`). The port imports nothing of ``tpu_dra_driver``."""

# the namespace the DRA driver's objects live in
DRIVER_NAMESPACE = "tpu-dra-driver"
