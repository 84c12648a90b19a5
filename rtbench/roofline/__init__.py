"""Operations and bytes of the port's kernels, counted from a cell's inputs
alone (the scene, the camera, the frame's size, the shading, the lights and,
for the soft backward, the loss's cotangent) with the benchmark's reference,
never from the port's bins, K caps or tiles; and the card's peaks."""
