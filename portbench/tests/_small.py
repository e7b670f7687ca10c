"""Tiny sizes of the configuration for the CPU tests: the same geometry,
engine settings and limits, a 5^3 lattice, 10 ions on a block of 32
centred sites, passes of 64 frames over a pool of 32 in blocks of 16."""
SMALL = dict(n_cells=5, n_sites=125, n_static=125, n_ions=10, n_centres=32,
             centred_block=[[0, 3, 2], [0, 4, 1], [0, 4, 1]], n_frames=64,
             distinct_frames=32, block_frames=16)
SIZES = {"sc10k": SMALL}
WORKLOADS = {"sc10k-hop-mem": "sc10k", "sc10k-hop-h5": "sc10k"}
SEED = 2 ** 31 + 11     # a seed past 32 signed bits
