"""The benchmark's plain reference: numpy and float64 PyTorch only.

Nothing here imports the system under test or JAX.  It makes the meshes
(`mesh`), applies the operators element by element (`fem`), reads a run's
answers against them (`problem`) and counts the plane layout's rows
(`padding`)."""
