"""The data layer: corpus -> vocabulary -> windows -> instance shards on
the host (numpy, with the C++ sweep of ``native/``), then the prefetching
feeder that copies batches to the device (``feeder``). The on-disk formats
are the reference's, byte for byte, so each package reads the other's data
dirs."""
