"""Dense transformer layers and assembly (``layers``, ``transformer``) and
the conversion of JAX parameter trees (``convert``)."""
