"""Multi-process layers (port of orb_slam3_tpu/parallel): the
landmark-sharded bundle adjustment, the global BA of a map over a process
group, two-level (host, device) groups and the cross-host Atlas, and the
fleet of tracking sessions. They run on `torch.distributed`: gloo for CPU
processes, NCCL between cards."""
