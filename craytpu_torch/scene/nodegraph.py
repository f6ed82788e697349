"""Material node-graph IR (host side).

The reference builds hash-consed vtable node DAGs (nodes/*, HASH_CONS in
nodebase.h:21-33). Here a graph is an immutable tuple tree; structural
equality IS the hash-consing (graphs that compare equal compile to one
shading program). The compile step (scene/compile.py) turns each unique bsdf
graph into a pure-JAX shading function whose constants live in differentiable
parameter tables.

Node kinds and semantics map 1:1 to the reference:
  bsdf:   diffuse metal glass plastic emissive mix add transparent
          isotropic background warning     (nodes/shaders/*)
  color:  const_color image checker gradient blackbody combine_rgb
          vec_to_color                      (nodes/textures, converter)
  value:  const_value grayscale alpha fresnel raylength math
          vec_to_value                      (nodes/converter, input)
  vector: const_vec normal vec_math         (nodes/input, converter)
"""

from __future__ import annotations

from craytpu_torch.scene.types import (MaterialHost, BSDF_EMISSION, BSDF_GLASS,
                                 BSDF_LAMBERTIAN, BSDF_METAL, BSDF_PLASTIC)

# image texture option bits (datatypes/image/texture.h)
NO_BILINEAR = 0x01
SRGB_TRANSFORM = 0x02

BLACK = (0.0, 0.0, 0.0, 1.0)
WHITE = (1.0, 1.0, 1.0, 1.0)
GRAY = (0.5, 0.5, 0.5, 1.0)

# math node ops (nodes/converter/math.c:42-95)
MATH_OPS = ("Add", "Subtract", "Multiply", "Divide", "Power", "Log",
            "SquareRoot", "Absolute", "Min", "Max", "Sine", "Cosine",
            "Tangent", "ToRadians", "ToDegrees")
# vecmath ops (nodes/converter/vecmath.c:41-81)
VEC_OPS = ("VecAdd", "VecSubtract", "VecMultiply", "VecAverage", "VecDot",
           "VecCross", "VecNormalize", "VecReflect", "VecLength", "VecAbs")


def const_color(rgba):
    return ("const_color", tuple(float(c) for c in rgba))


def const_value(x):
    return ("const_value", float(x))


def const_vec(v):
    return ("const_vec", tuple(float(c) for c in v))


def image(tex_id, options):
    return ("image", int(tex_id), int(options))


def checker(a=None, b=None, scale=None):
    return ("checker", a or const_color(BLACK), b or const_color(WHITE),
            scale or const_value(5.0))


def gradient(down, up):
    return ("gradient", tuple(map(float, down)), tuple(map(float, up)))


def grayscale(c=None):
    return ("grayscale", c or const_color(BLACK))


def alpha(c=None):
    return ("alpha", c or const_color(WHITE))


def blackbody_color(kelvin: float):
    """Blackbody with a constant kelvin collapses to a constant color at
    load time (parseTextureNode only ever feeds constants,
    sceneloader.c:826-830)."""
    return const_color(color_for_kelvin(kelvin))


def fresnel(ior=None, normal=None):
    return ("fresnel", ior or const_value(0.0), normal or ("normal",))


def math(a=None, b=None, op="Add"):
    assert op in MATH_OPS
    return ("math", a or const_value(0.0), b or const_value(0.0), op)


def vec_math(a=None, b=None, op="VecAdd"):
    assert op in VEC_OPS
    return ("vec_math", a or const_vec((0, 0, 0)), b or const_vec((0, 0, 0)),
            op)


def diffuse(color=None):
    return ("diffuse", color or const_color(BLACK))


def metal(color=None, roughness=None):
    return ("metal", color or const_color(BLACK),
            roughness or const_value(0.0))


def glass(color=None, roughness=None, ior=None):
    return ("glass", color or const_color(BLACK),
            roughness or const_value(0.0), ior or const_value(1.45))


def plastic(color=None):
    return ("plastic", color or const_color(BLACK))


def emissive(color=None, strength=None):
    return ("emissive", color or const_color(BLACK),
            strength or const_value(1.0))


def mix(a=None, b=None, factor=None):
    a = a or diffuse(const_color(BLACK))
    b = b or diffuse(const_color(BLACK))
    if a == b:  # pruning, mix.c:53-55
        return a
    return ("mix", a, b, factor or const_value(0.5))


def add(a=None, b=None):
    a = a or diffuse(const_color(BLACK))
    b = b or diffuse(const_color(BLACK))
    if a == b:  # add.c:46-47
        return a
    return ("add", a, b)


def transparent(color=None):
    return ("transparent", color or const_color(WHITE))


def isotropic(color=None):
    return ("isotropic", color or const_color(BLACK))


def background(tex=None, strength=None, offset=None):
    return ("background", tex or const_color(GRAY),
            strength or const_value(1.0), offset or const_value(0.0))


def warning_bsdf():
    """Obnoxious pink/gray checker fallback (bsdfnode.c:16-21)."""
    return mix(diffuse(const_color((1.0, 0.0, 0.5, 1.0))),
               diffuse(const_color((0.2, 0.2, 0.2, 1.0))),
               grayscale(checker(None, None, const_value(500.0))))


def unknown_texture():
    """unknownTextureNode: the checker itself, used for bad texture nodes."""
    return checker(None, None, const_value(500.0))


def append_alpha(base, color_node):
    """appendAlpha (material.c:58-65): mix(transparent(white), base, alpha)."""
    return mix(transparent(const_color(WHITE)), base, alpha(color_node))


def color_for_kelvin(kelvin: float):
    """Tanner Helland kelvin->RGB (color.c:29-73). NB alpha is 0."""
    import math as m
    temp = min(kelvin, 40000.0) / 100.0
    if temp <= 66.0:
        red = 255.0
    else:
        red = 329.698727446 * ((temp - 60.0) ** -0.1332047592)
        red = min(max(red, 0.0), 255.0)
    if temp <= 66.0:
        green = 99.4708025861 * m.log(temp) - 161.1195681661 if temp > 0 \
            else 0.0
        green = min(max(green, 0.0), 255.0)
    else:
        green = 288.1221695283 * ((temp - 60.0) ** -0.0755148492)
        green = min(max(green, 0.0), 255.0)
    if temp >= 66.0:
        blue = 255.0
    elif temp <= 19.0:
        blue = 0.0
    else:
        blue = 138.5177312231 * m.log(temp - 10.0) - 305.0447927307
        blue = min(max(blue, 0.0), 255.0)
    return (red / 255.0, green / 255.0, blue / 255.0, 0.0)


def assign_bsdf(mat: MaterialHost) -> None:
    """assignBSDF (material.c:67-111): legacy material -> node graph IR.

    Texture ids must already be resolved on the material. Every graph built
    here is wrapped in append_alpha (one extra mix dimension per bounce —
    parity-critical)."""
    rough = (grayscale(image(mat.specular_map, NO_BILINEAR))
             if mat.specular_map is not None else const_value(mat.roughness))
    color = (image(mat.texture, SRGB_TRANSFORM)
             if mat.texture is not None else const_color(mat.diffuse))
    mat.bsdf_ir = None
    spec = const_color(mat.specular)
    if mat.illum == 5:
        mat.bsdf_ir = append_alpha(metal(color, rough), color)
    elif mat.illum == 7:
        mat.bsdf_ir = append_alpha(
            glass(spec, rough, const_value(mat.ior)), spec)
    if mat.bsdf_ir is not None:
        return
    t = mat.type
    if t == BSDF_LAMBERTIAN:
        mat.bsdf_ir = append_alpha(diffuse(color), color)
    elif t == BSDF_GLASS:
        mat.bsdf_ir = append_alpha(
            glass(color, rough, const_value(mat.ior)), color)
    elif t == BSDF_METAL:
        mat.bsdf_ir = append_alpha(metal(color, rough), color)
    elif t == BSDF_PLASTIC:
        mat.bsdf_ir = append_alpha(plastic(color), color)
    elif t == BSDF_EMISSION:
        mat.bsdf_ir = append_alpha(diffuse(color), color)
    else:
        mat.bsdf_ir = warning_bsdf()
