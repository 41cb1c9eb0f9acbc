"""Host-side data of the port (numpy only): synthetic slices, the joint
dataset's item layout and the padded batcher."""
