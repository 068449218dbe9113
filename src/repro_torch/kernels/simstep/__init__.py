"""The sim's device iteration on the card: two one-block CUDA kernels
around the water-filling launch, and their wrappers."""
