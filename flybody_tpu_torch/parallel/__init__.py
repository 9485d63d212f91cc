"""Multi-GPU training: one process per GPU over torch.distributed
(``distributed``), the data-parallel plan of the loop state and the
gradient all-reduce (``mesh``), and a dry run of one training iteration
over W ranks (``dryrun``)."""
