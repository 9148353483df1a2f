"""Tools for the port: measurement and mutation scripts that need a CUDA
device, and the per-head-grid prototype (proto_nh_kernel), which also runs
on the CPU."""
