"""Ray, pinhole, Plücker and epipolar-segment geometry, in f32."""

from cross_attention_renderer_torch.geometry.rays import (
    closest_to_origin,
    epipolar_point_3d,
    essential_matrix,
    fundamental_matrix,
    homogenize_mat,
    lift,
    ndc_to_pixel,
    parse_intrinsics,
    pixel_to_ndc,
    plucker_distance,
    plucker_embedding,
    plucker_intersection,
    plucker_parallel,
    plucker_reciprocal_product,
    plucker_sd,
    points_to_cam,
    project_pinhole,
    ray_directions,
    ray_directions_cam,
    ray_origin,
    transform_dirs,
    transform_points,
    world_from_xy_depth,
)
from cross_attention_renderer_torch.geometry.epipolar import (
    PointProjection,
    RaySegmentProjection,
    epipolar_segments_ndc,
    project_rays,
    volumetric_epipolar_lines,
)

__all__ = [
    'PointProjection', 'RaySegmentProjection', 'closest_to_origin',
    'epipolar_point_3d', 'epipolar_segments_ndc', 'essential_matrix',
    'fundamental_matrix', 'homogenize_mat', 'lift', 'plucker_distance',
    'plucker_reciprocal_product',
    'ndc_to_pixel', 'parse_intrinsics', 'pixel_to_ndc', 'plucker_embedding',
    'plucker_intersection', 'plucker_parallel', 'plucker_sd', 'points_to_cam',
    'project_pinhole', 'project_rays', 'ray_directions', 'ray_directions_cam',
    'ray_origin', 'transform_dirs', 'transform_points',
    'volumetric_epipolar_lines', 'world_from_xy_depth',
]
