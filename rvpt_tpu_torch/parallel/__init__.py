"""Sharded rendering and training over ``torch.distributed`` (mirror of
``rvpt_tpu/parallel``): one process per device, film tiles split over the
``tiles`` axis of a ``(tiles, spp)`` device mesh and Monte-Carlo samples
over ``spp``, combined with collectives (``sharded``); process-group set-up
and the film's gather to one host (``distributed``); the mesh (``mesh``);
a multi-process dry run on the CPU (``dryrun``)."""
