"""Tri-Accel control: precision codes, control loop, grouping, memory-elastic
batch rungs and curvature."""
