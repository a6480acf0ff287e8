"""Traffic: one data file a mix (``<mix>.json``) and the general generators
it names by its ``generator`` key (``gen_regions``, ``gen_reads``).  A
generator takes the mix's parameters, the configuration and the run's seed,
and gives the same inputs for the same seed."""
