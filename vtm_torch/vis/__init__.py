from vtm_torch.vis.vis import (  # noqa: F401
    concatenate_images,
    generate_colormap,
    make_spatial_video_visualization,
    make_spatiotemporal_video_visualization,
    make_visualization,
)
