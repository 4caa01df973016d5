"""SLAM orchestration of the port: the frame/edge graph, keyframing and the
VO layer (``system.VOLDOR_SLAM``)."""
