"""The plain reference: MetaCache's build and query worked out again in
plain PyTorch from the benchmark's own genomes, taxonomy and reads."""
