"""Small shapes of the benchmark's configurations for the CPU tests."""

SMALL = {
    "dg_slice": {"builder_args": {"n": 1024, "n_agg": 4},
                 "discretization": {"n_elements": 1024, "c_dir": 1024000.0}},
    "north_star": {"builder_args": {"n": 16384, "spec": {"c_dir": 16384000.0, "n_agg_levels": 3}},
                   "discretization": {"n_elements": 16384, "c_dir": 16384000.0}},
}
CELLS = ("dg_slice.mixed_damped", "north_star.handover", "north_star.true", "dg_slice.f64")
SEED = 2**31 + 11
