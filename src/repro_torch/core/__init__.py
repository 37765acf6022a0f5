"""The Dom-ST model: Pix-Con, partitioner, spatial and temporal blocks."""
