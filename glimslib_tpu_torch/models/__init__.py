"""Models of the port: the P1 tumor-growth models on lattice meshes."""
