"""Device-side data modules (the host data code is ``sert_tpu.data``,
imported as it is): the prefetching feeder."""
