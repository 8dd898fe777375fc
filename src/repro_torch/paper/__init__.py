"""The paper's table and figure entries, run by the port: counterparts of
the `benchmarks/` entries that reproduce the paper (Fig. 1-4, Table 1, the
§2.2 J2 drift, the §2.3 radiation table and the §3 DiLoCo traffic), and
the roofline table of the port's dry run (`roofline`, which reads what
`repro_torch.launch.dryrun` wrote).  Each
module's `run()` returns ([(name, us_per_call, derived)], rows) as its
reference does.  These reproduce the paper's numbers; they are not the
port's throughput benchmark.

  PYTHONPATH=src python -m repro_torch.paper [--device cuda|cpu] \\
      [--skip fig2_constellation,j2_drift]
"""

ENTRIES = ("fig1_isl", "fig2_constellation", "j2_drift", "radiation_table",
           "fig4_launch", "table1_power", "diloco_traffic", "roofline")
# the entries whose run() takes a device: the J2 orbit and the micro
# DiLoCo run; the others are host numpy
ON_DEVICE = ("fig2_constellation", "j2_drift", "diloco_traffic")
