"""Parallel layers of the port: the named device mesh (`mesh`), the
logical-axis sharding rules as DTensor placements (`sharding`), ring
attention over sp (`ring_attention`), the pipeline over pp (`pipeline`)
and the Mixture-of-Experts layer, on one device and over ep (`moe`)."""
