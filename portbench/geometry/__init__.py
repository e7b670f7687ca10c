"""Site geometries of the benchmark's configurations, one module a kind,
found by the ``geometry`` key of a configuration file.  Each module's
``build(config)`` returns the cell, the static atoms' reference positions,
the site positions, each site's vertex atoms and its integer grid index
(``grid``), from which a configuration's ``centred_block`` picks the sites
that hold centres."""
