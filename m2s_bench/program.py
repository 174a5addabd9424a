"""The program under test as a user holds it: the benchmark's asset
tensors laid out as the port's GLB loader lays out a primitive, in a
``Scene``. The program gets its own copies, so nothing it does in place
reaches the inputs the reference reads."""

from __future__ import annotations


def scene(asset: dict):
    from mesh2splat_torch.io.gltf import GltfPrimitive
    from mesh2splat_torch.scene import Scene
    from mesh2splat_torch.types import Material, TriangleMesh

    geo = ("tri_pos", "tri_normal", "tri_tangent", "tri_uv")
    mesh = TriangleMesh(**{k: asset[k].clone() for k in geo})
    mat = Material(
        base_color_factor=asset["base_color_factor"].clone(),
        metallic_factor=float(asset["metallic_factor"]),
        roughness_factor=float(asset["roughness_factor"]),
        base_color=asset["base_color_tex"].clone(),
        normal=asset["normal_tex"].clone(),
        metallic_roughness=asset["metallic_roughness_tex"].clone(),
        has_base_color=True, has_normal=True, has_metallic_roughness=True)
    # the primitive's host record, for its bounding box; its maps stay on
    # the device in the Material, where gltf.to_device puts them
    host = {k: asset[k].cpu().numpy() for k in geo}
    prim = GltfPrimitive(
        name="synth", **host,
        base_color_factor=asset["base_color_factor"].cpu().numpy(),
        metallic_factor=float(asset["metallic_factor"]),
        roughness_factor=float(asset["roughness_factor"]),
        base_color_tex=None, normal_tex=None, metallic_roughness_tex=None)
    return Scene(primitives=[(mesh, mat, prim)])
