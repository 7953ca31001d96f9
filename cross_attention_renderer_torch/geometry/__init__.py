"""Ray, pinhole, Plücker and epipolar-segment geometry, in f32."""
